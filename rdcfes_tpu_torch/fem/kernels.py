"""The hand-written Hopper kernels, their wrappers, their plain PyTorch
versions and their launch counts.

  K1 gather_interp_affine  csrc/gather_interp_affine.cu   f64        transient
  K2 rhs_affine            csrc/rhs_affine.cu             f64        transient
  K3 apply_affine          csrc/apply_affine.cu           f32, f64   transient
  K4 restrict              csrc/restrict.cu               f32, f64   both
  K5 ell_matvec            csrc/ell_matvec.cu             f32, f64   solid
  K6 apply_generic         csrc/apply_generic.cu          f32, f64   transient
  K7 take_along            csrc/take_along.cu             f32        calibration
  K8 gather_interp_generic csrc/gather_interp_generic.cu  f64        transient

K1-K3 serve affine elements (TET4); K8 and K6 are K1's and K3's
counterparts for elements whose shape gradients differ per quadrature
point (HEX8).  K7 is the `take_along_axis(axis=0)` lookup of the
launch-cost calibration.  K4 is every element -> node (or node-pair)
gather-sum: the transient restriction and the solid path's vector and
matrix assembly (fem.assembly.assemble_*_gather).

Each wrapper takes its plain version for tensors on the CPU, and only
then.  For CUDA tensors it checks device, dtype, shape and contiguity,
allocates the outputs, launches the kernel on the current stream without
synchronising, raises if the launch reports an error, and adds one to the
variant's launch count.  The plain versions call the module functions the
kernels stand for (fem.assembly, fem.bcsr, fem.weakform), on any device.

Coefficient blocks reach K2, K3 and K6 as stacks of their live planes plus
small int32 (species) or (v, w) index lists, the counterpart of the
reference's stack_blocks and stack_blocks_affine
(rdcfes_tpu/fem/pallas_apply.py:33-102), without their element padding.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from .assembly import interpolate_ue, interpolate_ue_affine
from .assembly import restrict as restrict_plain
from .bcsr import ell_matvec as ell_matvec_plain
from .weakform import (WeakFormBlocks, _is_zero, block_rhs_affine, qp_apply,
                       qp_apply_affine)

MAX_V = 8  # csrc/common.cuh kMaxV

TRANSIENT_VARIANTS = ("gather_interp_affine_f64", "rhs_affine_f64",
                      "apply_affine_f32", "apply_affine_f64",
                      "restrict_f32", "restrict_f64")
SOLID_VARIANTS = ("restrict_f32", "restrict_f64", "ell_matvec_f32",
                  "ell_matvec_f64")
GENERIC_VARIANTS = ("gather_interp_generic_f64", "apply_generic_f32",
                    "apply_generic_f64", "restrict_f32", "restrict_f64")
KERNEL_VARIANTS = (TRANSIENT_VARIANTS
                   + ("ell_matvec_f32", "ell_matvec_f64",
                      "apply_generic_f32", "apply_generic_f64",
                      "take_along_f32", "gather_interp_generic_f64"))

_launches: Dict[str, int] = {name: 0 for name in KERNEL_VARIANTS}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per variant since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


# ----------------------------------------------------------------------
# stacked live blocks
# ----------------------------------------------------------------------
class RhsStacks(NamedTuple):
    """Live A/B blocks: A (nA, Q, E), B (nB, Q, 3, E); idxA/idxB int32
    species of each plane; n_vars species in all."""

    A: torch.Tensor
    idxA: np.ndarray
    B: torch.Tensor
    idxB: np.ndarray
    n_vars: int


class ApplyStacks(NamedTuple):
    """Live jacobian blocks: C (nC, Q, E), D (nD, Q, 3, E), Epre (nE, E)
    (diffusion_presum); idxC/idxD/idxE int32 (n, 2) rows (v, w)."""

    C: torch.Tensor
    idxC: np.ndarray
    D: torch.Tensor
    idxD: np.ndarray
    Epre: torch.Tensor
    idxE: np.ndarray
    n_vars: int


class GenericApplyStacks(NamedTuple):
    """Live jacobian blocks for per-q gradients: C (nC, Q, E), D
    (nD, Q, 3, E), E (nE, Q, E) (the diffusion planes stay per-q);
    idxC/idxD/idxE int32 (n, 2) rows (v, w)."""

    C: torch.Tensor
    idxC: np.ndarray
    D: torch.Tensor
    idxD: np.ndarray
    E: torch.Tensor
    idxE: np.ndarray
    n_vars: int


def _stack(planes, like: torch.Tensor, tail) -> torch.Tensor:
    if planes:
        return torch.stack(planes)
    return torch.empty((0,) + tuple(tail), dtype=like.dtype,
                       device=like.device)


def _first_live(wfb: WeakFormBlocks) -> torch.Tensor:
    return next(a for a in wfb.A if not _is_zero(a))


def stack_rhs(wfb: WeakFormBlocks) -> RhsStacks:
    ref = _first_live(wfb)
    Q, E = ref.shape
    ia = [v for v, a in enumerate(wfb.A) if not _is_zero(a)]
    ib = [v for v, b in enumerate(wfb.B) if not _is_zero(b)]
    return RhsStacks(
        A=_stack([wfb.A[v] for v in ia], ref, (Q, E)),
        idxA=np.asarray(ia, np.int32),
        B=_stack([wfb.B[v] for v in ib], ref, (Q, 3, E)),
        idxB=np.asarray(ib, np.int32), n_vars=wfb.n_vars)


def _stack_live(blocks, V: int, like: torch.Tensor, tail):
    """(stacked live planes of a [V][V] block table, their (v, w) rows)."""
    live = [(v, w) for v in range(V) for w in range(V)
            if not _is_zero(blocks[v][w])]
    return (_stack([blocks[v][w] for v, w in live], like, tail),
            np.asarray(live, np.int32).reshape(-1, 2))


def stack_apply(wfb: WeakFormBlocks, Epre) -> ApplyStacks:
    ref = _first_live(wfb)
    Q, E = ref.shape
    V = wfb.n_vars
    C, ic = _stack_live(wfb.C, V, ref, (Q, E))
    D, id_ = _stack_live(wfb.D, V, ref, (Q, 3, E))
    Ep, ie = _stack_live(Epre, V, ref, (E,))
    return ApplyStacks(C=C, idxC=ic, D=D, idxD=id_, Epre=Ep, idxE=ie,
                       n_vars=V)


def stack_apply_generic(wfb: WeakFormBlocks) -> GenericApplyStacks:
    ref = _first_live(wfb)
    Q, E = ref.shape
    V = wfb.n_vars
    C, ic = _stack_live(wfb.C, V, ref, (Q, E))
    D, id_ = _stack_live(wfb.D, V, ref, (Q, 3, E))
    Es, ie = _stack_live(wfb.E, V, ref, (Q, E))
    return GenericApplyStacks(C=C, idxC=ic, D=D, idxD=id_, E=Es, idxE=ie,
                              n_vars=V)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def gather_interp_affine_plain(u, conn_T, phi, dphi0):
    """u (V, N), conn_T (K, E) -> (u_qp (V, Q, E), gx (V, 3, E))."""
    return interpolate_ue_affine(u[:, conn_T], phi, dphi0)


def gather_interp_generic_plain(u, conn_T, phi, dphi):
    """u (V, N), conn_T (K, E), dphi (Q, K, 3, E) -> (u_qp (V, Q, E),
    gx (V, Q, 3, E))."""
    return interpolate_ue(u[:, conn_T], phi, dphi)


def rhs_affine_plain(st: RhsStacks, JxW, phi, dphi0):
    """Fe (V, K, E) = block_rhs_affine of the stacked A/B blocks."""
    A = [0.0] * st.n_vars
    B = [0.0] * st.n_vars
    for i, v in enumerate(st.idxA):
        A[v] = st.A[i]
    for i, v in enumerate(st.idxB):
        B[v] = st.B[i]
    wfb = WeakFormBlocks(A=tuple(A), B=tuple(B), C=(), D=(), E=())
    return block_rhs_affine(wfb, phi, JxW, dphi0[None])


def _unstack(V: int, planes, idx):
    """The [V][V] block table of stacked live planes (absent = 0.0)."""
    blocks = [[0.0] * V for _ in range(V)]
    for i, (v, w) in enumerate(idx):
        blocks[v][w] = planes[i]
    return blocks


def apply_affine_plain(x, conn_T, phi, JxW, dphi0, st: ApplyStacks):
    """Ye (V, K, E) = qp_apply_affine of the stacked blocks applied to the
    corner-gathered, interpolated x (V, N)."""
    V = st.n_vars
    wfb = WeakFormBlocks(A=(0.0,) * V, B=(0.0,) * V,
                         C=_unstack(V, st.C, st.idxC),
                         D=_unstack(V, st.D, st.idxD), E=())
    x_qp, gx = interpolate_ue_affine(x[:, conn_T], phi, dphi0)
    return qp_apply_affine(wfb, _unstack(V, st.Epre, st.idxE), phi, JxW,
                           dphi0[None], x_qp, gx)


def apply_generic_plain(x, conn_T, phi, JxW, dphi, st: GenericApplyStacks):
    """Ye (V, K, E) = qp_apply of the stacked blocks applied to the
    corner-gathered x (V, N), interpolated with per-q gradients dphi
    (Q, K, 3, E)."""
    V = st.n_vars
    wfb = WeakFormBlocks(A=(0.0,) * V, B=(0.0,) * V,
                         C=_unstack(V, st.C, st.idxC),
                         D=_unstack(V, st.D, st.idxD),
                         E=_unstack(V, st.E, st.idxE))
    x_qp, gx_qp = interpolate_ue(x[:, conn_T], phi, dphi)
    return qp_apply(wfb, phi, JxW, dphi, x_qp, gx_qp)


def take_along_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[m, l] = tbl[idx[m, l], l] (numpy's take_along_axis, axis 0)."""
    return torch.gather(tbl, 0, idx.long())


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr() if t.numel() else 0)


def _host(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _phi_host(phi, Q: int, K: int) -> np.ndarray:
    p = np.ascontiguousarray(np.asarray(phi, dtype=np.float64))
    if p.shape != (Q, K):
        raise ValueError(f"phi: shape {p.shape}, expected {(Q, K)}")
    return p


def _launch(variant: str, fn: Callable, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{variant}: kernel launch failed, cudaError {rc}")
    _launches[variant] += 1


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _lib():
    from ._build import library

    return library()


def _apply_slots(st) -> np.ndarray:
    """(3, MAX_V, MAX_V) int32: (v, w) -> plane index in the C, D and E
    stacks of K3/K6, or -1 where the block is absent."""
    slots = np.full((3, MAX_V, MAX_V), -1, np.int32)
    for t, idx in enumerate((st.idxC, st.idxD, st.idxE)):
        slots[t, idx[:, 0], idx[:, 1]] = np.arange(len(idx))
    return slots


def gather_interp_affine(u: torch.Tensor, conn_T: torch.Tensor, phi,
                         dphi0: torch.Tensor):
    """K1: u (V, N) f64, conn_T (K, E) int32, phi (Q, K) host table,
    dphi0 (K, 3, E) f64 -> (u_qp (V, Q, E), gx (V, 3, E))."""
    if _on_cpu(u):
        return gather_interp_affine_plain(u, conn_T, phi, dphi0)
    V, N = u.shape
    K, E = conn_T.shape
    Q = np.shape(phi)[0]
    dev, f64 = u.device, torch.float64
    _check("u", u, dev, f64, (V, N))
    _check("conn_T", conn_T, dev, torch.int32, (K, E))
    _check("dphi0", dphi0, dev, f64, (K, 3, E))
    ph = _phi_host(phi, Q, K)
    u_qp = torch.empty((V, Q, E), dtype=f64, device=dev)
    gx = torch.empty((V, 3, E), dtype=f64, device=dev)
    with torch.cuda.device(dev):
        _launch("gather_interp_affine_f64",
                _lib().rdc_gather_interp_affine_f64, _ptr(u), _ptr(conn_T),
                _host(ph), _ptr(dphi0), _ptr(u_qp), _ptr(gx), V, N, K, Q, E,
                _stream(dev))
    return u_qp, gx


GENERIC_KQ = ((8, 8),)  # (K, Q) pairs K6 and K8 are instantiated for


def _check_kq(name: str, K: int, Q: int) -> None:
    if (K, Q) not in GENERIC_KQ:
        raise ValueError(f"{name}: no kernel for K={K}, Q={Q} "
                         f"(built for {GENERIC_KQ})")


def gather_interp_generic(u: torch.Tensor, conn_T: torch.Tensor, phi,
                          dphi: torch.Tensor):
    """K8: u (V, N) f64, conn_T (K, E) int32, phi (Q, K) host table,
    dphi (Q, K, 3, E) f64 -> (u_qp (V, Q, E), gx (V, Q, 3, E))."""
    if _on_cpu(u):
        return gather_interp_generic_plain(u, conn_T, phi, dphi)
    V, N = u.shape
    K, E = conn_T.shape
    Q = np.shape(phi)[0]
    dev, f64 = u.device, torch.float64
    _check_kq("gather_interp_generic", K, Q)
    _check("u", u, dev, f64, (V, N))
    _check("conn_T", conn_T, dev, torch.int32, (K, E))
    _check("dphi", dphi, dev, f64, (Q, K, 3, E))
    ph = _phi_host(phi, Q, K)
    u_qp = torch.empty((V, Q, E), dtype=f64, device=dev)
    gx = torch.empty((V, Q, 3, E), dtype=f64, device=dev)
    with torch.cuda.device(dev):
        _launch("gather_interp_generic_f64",
                _lib().rdc_gather_interp_generic_f64, _ptr(u), _ptr(conn_T),
                _host(ph), _ptr(dphi), _ptr(u_qp), _ptr(gx), V, N, K, Q, E,
                _stream(dev))
    return u_qp, gx


def rhs_affine(st: RhsStacks, JxW: torch.Tensor, phi, dphi0: torch.Tensor):
    """K2: stacked A/B blocks, JxW (Q, E) f64, phi (Q, K) host table,
    dphi0 (K, 3, E) f64 -> Fe (V, K, E) f64."""
    if _on_cpu(JxW):
        return rhs_affine_plain(st, JxW, phi, dphi0)
    V = st.n_vars
    Q, E = JxW.shape
    K = dphi0.shape[0]
    dev, f64 = JxW.device, torch.float64
    if not 1 <= V <= MAX_V:
        raise ValueError(f"rhs_affine: {V} species, kernel takes 1..{MAX_V}")
    _check("JxW", JxW, dev, f64, (Q, E))
    _check("dphi0", dphi0, dev, f64, (K, 3, E))
    _check("A", st.A, dev, f64, (len(st.idxA), Q, E))
    _check("B", st.B, dev, f64, (len(st.idxB), Q, 3, E))
    slots = np.full((2, MAX_V), -1, np.int32)
    slots[0, st.idxA] = np.arange(len(st.idxA))
    slots[1, st.idxB] = np.arange(len(st.idxB))
    ph = _phi_host(phi, Q, K)
    Fe = torch.empty((V, K, E), dtype=f64, device=dev)
    with torch.cuda.device(dev):
        _launch("rhs_affine_f64", _lib().rdc_rhs_affine_f64, _ptr(st.A),
                _ptr(st.B), _host(slots), _ptr(JxW), _host(ph), _ptr(dphi0),
                _ptr(Fe), V, K, Q, E, _stream(dev))
    return Fe


def apply_affine(x: torch.Tensor, conn_T: torch.Tensor, phi,
                 JxW: torch.Tensor, dphi0: torch.Tensor, st: ApplyStacks):
    """K3: x (V, N) f32 or f64, conn_T (K, E) int32, phi (Q, K) host
    table, JxW (Q, E), dphi0 (K, 3, E) and the stacked blocks, all in x's
    dtype -> Ye (V, K, E)."""
    if _on_cpu(x):
        return apply_affine_plain(x, conn_T, phi, JxW, dphi0, st)
    V, N = x.shape
    K, E = conn_T.shape
    Q = JxW.shape[0]
    dev, dt = x.device, x.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"apply_affine: no kernel for {dt}")
    if V != st.n_vars or not 1 <= V <= MAX_V:
        raise ValueError(f"apply_affine: {V} species, stacks carry "
                         f"{st.n_vars}, kernel takes 1..{MAX_V}")
    _check("x", x, dev, dt, (V, N))
    _check("conn_T", conn_T, dev, torch.int32, (K, E))
    _check("JxW", JxW, dev, dt, (Q, E))
    _check("dphi0", dphi0, dev, dt, (K, 3, E))
    _check("C", st.C, dev, dt, (len(st.idxC), Q, E))
    _check("D", st.D, dev, dt, (len(st.idxD), Q, 3, E))
    _check("Epre", st.Epre, dev, dt, (len(st.idxE), E))
    slots = _apply_slots(st)
    ph = _phi_host(phi, Q, K)
    Ye = torch.empty((V, K, E), dtype=dt, device=dev)
    variant = "apply_affine_f32" if dt == torch.float32 else "apply_affine_f64"
    with torch.cuda.device(dev):
        _launch(variant, getattr(_lib(), "rdc_" + variant), _ptr(x),
                _ptr(conn_T), _host(ph), _ptr(JxW), _ptr(dphi0), _ptr(st.C),
                _ptr(st.D), _ptr(st.Epre), _host(slots), _ptr(Ye), V, N, K, Q,
                E, _stream(dev))
    return Ye


def apply_generic(x: torch.Tensor, conn_T: torch.Tensor, phi,
                  JxW: torch.Tensor, dphi: torch.Tensor,
                  st: GenericApplyStacks):
    """K6: x (V, N) f32 or f64, conn_T (K, E) int32, phi (Q, K) host
    table, JxW (Q, E), dphi (Q, K, 3, E) and the stacked blocks, all in x's
    dtype -> Ye (V, K, E)."""
    if _on_cpu(x):
        return apply_generic_plain(x, conn_T, phi, JxW, dphi, st)
    V, N = x.shape
    K, E = conn_T.shape
    Q = JxW.shape[0]
    dev, dt = x.device, x.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"apply_generic: no kernel for {dt}")
    if V != st.n_vars or not 1 <= V <= MAX_V:
        raise ValueError(f"apply_generic: {V} species, stacks carry "
                         f"{st.n_vars}, kernel takes 1..{MAX_V}")
    _check_kq("apply_generic", K, Q)
    _check("x", x, dev, dt, (V, N))
    _check("conn_T", conn_T, dev, torch.int32, (K, E))
    _check("JxW", JxW, dev, dt, (Q, E))
    _check("dphi", dphi, dev, dt, (Q, K, 3, E))
    _check("C", st.C, dev, dt, (len(st.idxC), Q, E))
    _check("D", st.D, dev, dt, (len(st.idxD), Q, 3, E))
    _check("E", st.E, dev, dt, (len(st.idxE), Q, E))
    slots = _apply_slots(st)
    ph = _phi_host(phi, Q, K)
    Ye = torch.empty((V, K, E), dtype=dt, device=dev)
    variant = ("apply_generic_f32" if dt == torch.float32
               else "apply_generic_f64")
    with torch.cuda.device(dev):
        _launch(variant, getattr(_lib(), "rdc_" + variant), _ptr(x),
                _ptr(conn_T), _host(ph), _ptr(JxW), _ptr(dphi), _ptr(st.C),
                _ptr(st.D), _ptr(st.E), _host(slots), _ptr(Ye), V, N, K, Q,
                E, _stream(dev))
    return Ye


def take_along(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7: tbl (S, L) f32, idx (M, L) int32 with entries in [0, S) ->
    out (M, L) f32, out[m, l] = tbl[idx[m, l], l]."""
    if _on_cpu(tbl):
        return take_along_plain(tbl, idx)
    S, L = tbl.shape
    M = idx.shape[0]
    dev = tbl.device
    _check("tbl", tbl, dev, torch.float32, (S, L))
    _check("idx", idx, dev, torch.int32, (M, L))
    out = torch.empty((M, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("take_along_f32", _lib().rdc_take_along_f32, _ptr(tbl),
                _ptr(idx), _ptr(out), S, M, L, _stream(dev))
    return out


def restrict(flat: torch.Tensor, node_gather: torch.Tensor) -> torch.Tensor:
    """K4: flat (W, K*E) f32 or f64, node_gather (C, N) int32 (pad = K*E)
    -> y (W, N)."""
    if _on_cpu(flat):
        return restrict_plain(flat, node_gather)
    W, KE = flat.shape
    C, N = node_gather.shape
    dev, dt = flat.device, flat.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"restrict: no kernel for {dt}")
    _check("flat", flat, dev, dt, (W, KE))
    _check("node_gather", node_gather, dev, torch.int32, (C, N))
    y = torch.empty((W, N), dtype=dt, device=dev)
    variant = "restrict_f32" if dt == torch.float32 else "restrict_f64"
    with torch.cuda.device(dev):
        _launch(variant, getattr(_lib(), "rdc_" + variant), _ptr(flat),
                _ptr(node_gather), _ptr(y), W, C, N, KE, _stream(dev))
    return y


def ell_matvec(values_ell: torch.Tensor, ell_cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """K5: values_ell (V, W, L, N) f32 or f64, ell_cols (L, N) int32, x
    (W, N) in values' dtype -> y (V, N)."""
    if _on_cpu(values_ell):
        return ell_matvec_plain(values_ell, ell_cols, x)
    V, W, L, N = values_ell.shape
    dev, dt = values_ell.device, values_ell.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"ell_matvec: no kernel for {dt}")
    if not 1 <= W <= MAX_V:
        raise ValueError(f"ell_matvec: {W} columns per block, kernel takes "
                         f"1..{MAX_V}")
    _check("values_ell", values_ell, dev, dt, (V, W, L, N))
    _check("ell_cols", ell_cols, dev, torch.int32, (L, N))
    _check("x", x, dev, dt, (W, N))
    y = torch.empty((V, N), dtype=dt, device=dev)
    variant = "ell_matvec_f32" if dt == torch.float32 else "ell_matvec_f64"
    with torch.cuda.device(dev):
        _launch(variant, getattr(_lib(), "rdc_" + variant), _ptr(values_ell),
                _ptr(ell_cols), _ptr(x), _ptr(y), V, W, L, N, _stream(dev))
    return y


class Ops(NamedTuple):
    """The operations the kernels carry, as kernels or as plain torch."""

    gather_interp_affine: Callable
    rhs_affine: Callable
    apply_affine: Callable
    restrict: Callable
    ell_matvec: Callable
    apply_generic: Callable
    take_along: Callable
    gather_interp_generic: Callable


KERNEL_OPS = Ops(gather_interp_affine, rhs_affine, apply_affine, restrict,
                 ell_matvec, apply_generic, take_along,
                 gather_interp_generic)
PLAIN_OPS = Ops(gather_interp_affine_plain, rhs_affine_plain,
                apply_affine_plain, restrict_plain, ell_matvec_plain,
                apply_generic_plain, take_along_plain,
                gather_interp_generic_plain)
