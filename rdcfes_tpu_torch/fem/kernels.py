"""The four hand-written Hopper kernels of the transient qp path, their
wrappers, their plain PyTorch versions and their launch counts.

  K1 gather_interp_affine  csrc/gather_interp_affine.cu   f64
  K2 rhs_affine            csrc/rhs_affine.cu             f64
  K3 apply_affine          csrc/apply_affine.cu           f32, f64
  K4 restrict              csrc/restrict.cu               f32, f64

Each wrapper takes its plain version for tensors on the CPU, and only
then.  For CUDA tensors it checks device, dtype, shape and contiguity,
allocates the outputs, launches the kernel on the current stream without
synchronising, raises if the launch reports an error, and adds one to the
variant's launch count.  The plain versions call the module functions the
kernels stand for (fem.assembly, fem.weakform), on any device.

Coefficient blocks reach K2 and K3 as stacks of their live planes plus
small int32 (species) or (v, w) index lists, the counterpart of the
reference's stack_blocks_affine (rdcfes_tpu/fem/pallas_apply.py:69-102).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from .assembly import interpolate_ue_affine
from .assembly import restrict as restrict_plain
from .weakform import (WeakFormBlocks, _is_zero, block_rhs_affine,
                       qp_apply_affine)

MAX_V = 8  # csrc/common.cuh kMaxV

KERNEL_VARIANTS = ("gather_interp_affine_f64", "rhs_affine_f64",
                   "apply_affine_f32", "apply_affine_f64",
                   "restrict_f32", "restrict_f64")

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


def stack_apply(wfb: WeakFormBlocks, Epre) -> ApplyStacks:
    ref = _first_live(wfb)
    Q, E = ref.shape
    V = wfb.n_vars
    live = lambda blocks: [(v, w) for v in range(V) for w in range(V)
                           if not _is_zero(blocks[v][w])]
    ic, id_, ie = live(wfb.C), live(wfb.D), live(Epre)
    idx = lambda pairs: np.asarray(pairs, np.int32).reshape(-1, 2)
    return ApplyStacks(
        C=_stack([wfb.C[v][w] for v, w in ic], ref, (Q, E)), idxC=idx(ic),
        D=_stack([wfb.D[v][w] for v, w in id_], ref, (Q, 3, E)),
        idxD=idx(id_),
        Epre=_stack([Epre[v][w] for v, w in ie], ref, (E,)), idxE=idx(ie),
        n_vars=V)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def gather_interp_affine_plain(u, conn_T, phi, dphi0):
    """u (V, N), conn_T (K, E) -> (u_qp (V, Q, E), gx (V, 3, E))."""
    return interpolate_ue_affine(u[:, conn_T], phi, dphi0)


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


def apply_affine_plain(x, conn_T, phi, JxW, dphi0, st: ApplyStacks):
    """Ye (V, K, E) = qp_apply_affine of the stacked blocks applied to the
    corner-gathered, interpolated x (V, N)."""
    V = st.n_vars
    blocks = lambda: [[0.0] * V for _ in range(V)]
    C, D, Ep = blocks(), blocks(), blocks()
    for dst, planes, idx in ((C, st.C, st.idxC), (D, st.D, st.idxD),
                             (Ep, st.Epre, st.idxE)):
        for i, (v, w) in enumerate(idx):
            dst[v][w] = planes[i]
    wfb = WeakFormBlocks(A=(0.0,) * V, B=(0.0,) * V, C=C, D=D, E=())
    x_qp, gx = interpolate_ue_affine(x[:, conn_T], phi, dphi0)
    return qp_apply_affine(wfb, Ep, phi, JxW, dphi0[None], x_qp, gx)


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
    slots = np.full((3, MAX_V, MAX_V), -1, np.int32)
    for t, idx in enumerate((st.idxC, st.idxD, st.idxE)):
        slots[t, idx[:, 0], idx[:, 1]] = np.arange(len(idx))
    ph = _phi_host(phi, Q, K)
    Ye = torch.empty((V, K, E), dtype=dt, device=dev)
    variant = "apply_affine_f32" if dt == torch.float32 else "apply_affine_f64"
    with torch.cuda.device(dev):
        _launch(variant, getattr(_lib(), "rdc_" + variant), _ptr(x),
                _ptr(conn_T), _host(ph), _ptr(JxW), _ptr(dphi0), _ptr(st.C),
                _ptr(st.D), _ptr(st.Epre), _host(slots), _ptr(Ye), V, N, K, Q,
                E, _stream(dev))
    return Ye


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


class Ops(NamedTuple):
    """The four operations of the qp path, as kernels or as plain torch."""

    gather_interp_affine: Callable
    rhs_affine: Callable
    apply_affine: Callable
    restrict: Callable


KERNEL_OPS = Ops(gather_interp_affine, rhs_affine, apply_affine, restrict)
PLAIN_OPS = Ops(gather_interp_affine_plain, rhs_affine_plain,
                apply_affine_plain, restrict_plain)
