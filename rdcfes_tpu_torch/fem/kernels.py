"""The hand-written Hopper kernels, their wrappers, their plain PyTorch
versions and their launch counts.

  K1 gather_interp_affine  csrc/gather_interp_affine.cu   f32, f64   transient
  K2 rhs_affine            csrc/rhs_affine.cu             f32, f64   transient
  K3 apply_affine          csrc/apply_affine.cu           f32, f64   transient
  K4 restrict              csrc/restrict.cu               f32, f64   both
  K5 ell_matvec            csrc/ell_matvec.cu             f32, f64   solid
  K6 apply_generic         csrc/apply_generic.cu          f32, f64   transient
  K7 take_along            csrc/take_along.cu             f32        calibration
  K8 gather_interp_generic csrc/gather_interp_generic.cu  f32, f64   transient

The f32 instances of K1, K2 and K8 serve the transient systems'
dtype=float32 mode (a step's state, geometry and blocks in f32); the f64
ones every f64 system.  Each wrapper picks the instance from its input's
dtype, as K3, K4 and K6 do.

K1-K3 serve affine elements, one instance per type (AFFINE_KQ: TET4,
TRI3); K8 and K6 are K1's and K3's counterparts for elements whose shape
gradients differ per quadrature point, one instance per element type
(GENERIC_KQ: HEX8, PRISM6, PYRAMID5, TET10, QUAD4, QUAD8, QUAD9, HEX20,
HEX27).  Each launch of K1-K3, K6 and K8 is counted under its variant and
under its instance, "<variant>:<element type>".  A CUDA tensor at a
(K, Q) with no instance raises ValueError.  K7 is the
`take_along_axis(axis=0)` lookup of the launch-cost calibration.  K4 is
every element -> node (or node-pair) gather-sum: the transient
restriction and the solid path's vector and matrix assembly
(fem.assembly.assemble_*_gather).

Each wrapper takes its plain version for tensors on the CPU, and only
then.  For CUDA tensors it checks device, dtype, shape and contiguity,
allocates the outputs, launches the kernel on the current stream without
synchronising, raises if the launch reports an error, and adds one to the
variant's launch count.  The plain versions call the module functions the
kernels stand for (fem.assembly, fem.bcsr, fem.weakform), on any device.

K3, K4 and K6, the kernels of every Krylov iteration, launch from plans
(csrc/common.cuh): what stays fixed for a step (the stacks with the
element tables: `apply_launch_data`) or for a system's life (a gather
table: `restrict_table`) is checked once, when its plan is made, and
written into a C struct; a launch then checks only the tensor that
changes per call (x, flat) and passes the plan, that tensor, the output
and the current stream.  An apply plan lives in its stacks' `plans`
dict, keyed by the identity of the element tables it holds; a table
plan in a module dict keyed by the identity of its table, dropped when
the table is freed.  Tables and stacks are read-only once made: a plan
does not see a tensor resized in place.

Coefficient blocks reach K2, K3 and K6 as stacks of their live planes plus
small int32 (species) or (v, w) index lists, the counterpart of the
reference's stack_blocks and stack_blocks_affine
(rdcfes_tpu/fem/pallas_apply.py:33-102), without their element padding.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .assembly import interpolate_ue, interpolate_ue_affine
from .assembly import restrict as restrict_plain
from .bcsr import ell_matvec as ell_matvec_plain
from .weakform import (WeakFormBlocks, _is_zero, block_rhs_affine, qp_apply,
                       qp_apply_affine)

MAX_V = 8  # csrc/common.cuh kMaxV
PLAN_BYTES = 2048  # csrc/common.cuh kPlanBytes: room for any launch plan

# the launches of a mixed-precision (f64) step, and of an f32 system's step
TRANSIENT_VARIANTS = ("gather_interp_affine_f64", "rhs_affine_f64",
                      "apply_affine_f32", "apply_affine_f64",
                      "restrict_f32", "restrict_f64")
TRANSIENT_F32_VARIANTS = ("gather_interp_affine_f32", "rhs_affine_f32",
                          "apply_affine_f32", "restrict_f32")
SOLID_VARIANTS = ("restrict_f32", "restrict_f64", "ell_matvec_f32",
                  "ell_matvec_f64")
GENERIC_VARIANTS = ("gather_interp_generic_f64", "apply_generic_f32",
                    "apply_generic_f64", "restrict_f32", "restrict_f64")
GENERIC_F32_VARIANTS = ("gather_interp_generic_f32", "apply_generic_f32",
                        "restrict_f32")
KERNEL_VARIANTS = (TRANSIENT_VARIANTS
                   + ("ell_matvec_f32", "ell_matvec_f64",
                      "apply_generic_f32", "apply_generic_f64",
                      "take_along_f32", "gather_interp_generic_f64",
                      "gather_interp_affine_f32", "rhs_affine_f32",
                      "gather_interp_generic_f32"))

# (K, Q) -> the element type K1-K3 are instantiated for
AFFINE_KQ = {(4, 5): "tet4", (3, 4): "tri3"}
# (K, Q) -> the element type K6 and K8 are instantiated for
GENERIC_KQ = {(8, 8): "hex8", (6, 8): "prism6", (5, 8): "pyramid5",
              (10, 14): "tet10", (4, 4): "quad4", (8, 9): "quad8",
              (9, 9): "quad9", (20, 27): "hex20", (27, 27): "hex27"}
AFFINE_INSTANCES = tuple(
    f"{v}:{elem}" for v in ("gather_interp_affine_f64",
                            "gather_interp_affine_f32", "rhs_affine_f64",
                            "rhs_affine_f32", "apply_affine_f32",
                            "apply_affine_f64")
    for elem in AFFINE_KQ.values())
GENERIC_INSTANCES = tuple(
    f"{v}:{elem}" for v in ("gather_interp_generic_f64",
                            "gather_interp_generic_f32", "apply_generic_f32",
                            "apply_generic_f64")
    for elem in GENERIC_KQ.values())
# csrc/common.cuh kRegRows: the largest K whose gradient rows K6 and K8
# keep in registers; above it K8 holds a species' sums in registers, so it
# takes at most MAX_V species
REG_ROWS = 10

_launches: Dict[str, int] = {name: 0 for name in KERNEL_VARIANTS
                             + AFFINE_INSTANCES + GENERIC_INSTANCES}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per variant, and per K1-K3, K6 and K8 instance,
    since the last reset."""
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
    (diffusion_presum); idxC/idxD/idxE int32 (n, 2) rows (v, w); plans:
    K3's launch plans of these stacks (None: none are kept)."""

    C: torch.Tensor
    idxC: np.ndarray
    D: torch.Tensor
    idxD: np.ndarray
    Epre: torch.Tensor
    idxE: np.ndarray
    n_vars: int
    plans: Optional[dict] = None


class GenericApplyStacks(NamedTuple):
    """Live jacobian blocks for per-q gradients: C (nC, Q, E), D
    (nD, Q, 3, E), E (nE, Q, E) (the diffusion planes stay per-q);
    idxC/idxD/idxE int32 (n, 2) rows (v, w); plans: K6's launch plans of
    these stacks (None: none are kept)."""

    C: torch.Tensor
    idxC: np.ndarray
    D: torch.Tensor
    idxD: np.ndarray
    E: torch.Tensor
    idxE: np.ndarray
    n_vars: int
    plans: Optional[dict] = None


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
                       n_vars=V, plans={})


def stack_apply_generic(wfb: WeakFormBlocks) -> GenericApplyStacks:
    ref = _first_live(wfb)
    Q, E = ref.shape
    V = wfb.n_vars
    C, ic = _stack_live(wfb.C, V, ref, (Q, E))
    D, id_ = _stack_live(wfb.D, V, ref, (Q, 3, E))
    Es, ie = _stack_live(wfb.E, V, ref, (Q, E))
    return GenericApplyStacks(C=C, idxC=ic, D=D, idxD=id_, E=Es, idxE=ie,
                              n_vars=V, plans={})


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


def _check_fast(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    """_check for a launch's per-call tensor: one test when it passes."""
    if (t.dtype is not dtype or t.shape != shape or t.device != device
            or not t.is_contiguous()):
        _check(name, t, device, dtype, shape)


_TAG = {torch.float32: "f32", torch.float64: "f64"}


def _float_tag(name: str, dt: torch.dtype) -> str:
    """"f32" or "f64", the tag of a kernel's instance for dtype dt;
    TypeError for a dtype no kernel takes."""
    if dt not in _TAG:
        raise TypeError(f"{name}: no kernel for {dt}")
    return _TAG[dt]


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr() if t.numel() else 0


def _host(a: np.ndarray) -> int:
    return a.ctypes.data


def _phi_host(phi, Q: int, K: int) -> np.ndarray:
    p = np.ascontiguousarray(np.asarray(phi, dtype=np.float64))
    if p.shape != (Q, K):
        raise ValueError(f"phi: shape {p.shape}, expected {(Q, K)}")
    return p


_phi_tables: Dict[tuple, torch.Tensor] = {}


def _phi_dev(ph: np.ndarray, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A (Q, K) phi table on the device in `dtype`, made once per table,
    type and device: the copy K6 and K8 read where the table is too large
    for the kernel parameters (K * Q > csrc/common.cuh kMaxQK)."""
    key = (ph.tobytes(), ph.shape, dtype, device)
    t = _phi_tables.get(key)
    if t is None:
        t = _phi_tables[key] = torch.as_tensor(ph, dtype=dtype,
                                               device=device)
    return t


def _launch(variant: str, fn: Callable, *args, instance: str = "") -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{variant}: kernel launch failed, cudaError {rc}")
    _launches[variant] += 1
    if instance:
        _launches[instance] += 1


def _stream(device: torch.device) -> int:
    """The current stream of `device` as a raw cudaStream_t."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on_device(device: torch.device):
    """torch.cuda.device(device) where it is not the current device."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_fns: Dict[str, Callable] = {}


def _fn(variant: str) -> Callable:
    """The C entry point rdc_<variant> of the kernel library (built and
    bound on first use, looked up once)."""
    f = _fns.get(variant)
    if f is None:
        from ._build import library

        f = _fns[variant] = getattr(library(), "rdc_" + variant)
    return f


def _plan(init: str, *args):
    """A launch plan: a buffer of PLAN_BYTES that the C entry point
    rdc_<init> fills from args; returns (buffer, its address)."""
    buf = ctypes.create_string_buffer(PLAN_BYTES)
    rc = _fn(init)(ctypes.addressof(buf), PLAN_BYTES, *args)
    if rc != 0:
        raise RuntimeError(f"{init}: no plan for these shapes, cudaError {rc}")
    return buf, ctypes.addressof(buf)


def _apply_slots(st) -> np.ndarray:
    """(3, MAX_V, MAX_V) int32: (v, w) -> plane index in the C, D and E
    stacks of K3/K6, or -1 where the block is absent."""
    slots = np.full((3, MAX_V, MAX_V), -1, np.int32)
    for t, idx in enumerate((st.idxC, st.idxD, st.idxE)):
        slots[t, idx[:, 0], idx[:, 1]] = np.arange(len(idx))
    return slots


def _check_affine_kq(name: str, K: int, Q: int) -> str:
    """The instance tag of K1's, K2's or K3's (K, Q); ValueError if not
    built."""
    if (K, Q) not in AFFINE_KQ:
        raise ValueError(f"{name}: no kernel for K={K}, Q={Q} "
                         f"(built for {tuple(AFFINE_KQ)})")
    return AFFINE_KQ[(K, Q)]


def gather_interp_affine(u: torch.Tensor, conn_T: torch.Tensor, phi,
                         dphi0: torch.Tensor):
    """K1: u (V, N) f32 or f64, conn_T (K, E) int32, phi (Q, K) host table,
    dphi0 (K, 3, E) in u's dtype -> (u_qp (V, Q, E), gx (V, 3, E))."""
    if _on_cpu(u):
        return gather_interp_affine_plain(u, conn_T, phi, dphi0)
    V, N = u.shape
    K, E = conn_T.shape
    Q = np.shape(phi)[0]
    dev, dt = u.device, u.dtype
    variant = "gather_interp_affine_" + _float_tag("gather_interp_affine", dt)
    elem = _check_affine_kq("gather_interp_affine", K, Q)
    _check("u", u, dev, dt, (V, N))
    _check("conn_T", conn_T, dev, torch.int32, (K, E))
    _check("dphi0", dphi0, dev, dt, (K, 3, E))
    ph = _phi_host(phi, Q, K)
    u_qp = torch.empty((V, Q, E), dtype=dt, device=dev)
    gx = torch.empty((V, 3, E), dtype=dt, device=dev)
    with _on_device(dev):
        _launch(variant, _fn(variant), _ptr(u), _ptr(conn_T), _host(ph),
                _ptr(dphi0), _ptr(u_qp), _ptr(gx), V, N, K, Q, E,
                _stream(dev), instance=f"{variant}:{elem}")
    return u_qp, gx


def _check_kq(name: str, K: int, Q: int) -> str:
    """The instance tag of K6's or K8's (K, Q); ValueError if not built."""
    if (K, Q) not in GENERIC_KQ:
        raise ValueError(f"{name}: no kernel for K={K}, Q={Q} "
                         f"(built for {tuple(GENERIC_KQ)})")
    return GENERIC_KQ[(K, Q)]


def gather_interp_generic(u: torch.Tensor, conn_T: torch.Tensor, phi,
                          dphi: torch.Tensor):
    """K8: u (V, N) f32 or f64, conn_T (K, E) int32, phi (Q, K) host table,
    dphi (Q, K, 3, E) in u's dtype -> (u_qp (V, Q, E), gx (V, Q, 3, E))."""
    if _on_cpu(u):
        return gather_interp_generic_plain(u, conn_T, phi, dphi)
    V, N = u.shape
    K, E = conn_T.shape
    Q = np.shape(phi)[0]
    dev, dt = u.device, u.dtype
    variant = "gather_interp_generic_" + _float_tag("gather_interp_generic",
                                                    dt)
    elem = _check_kq("gather_interp_generic", K, Q)
    if K > REG_ROWS and V > MAX_V:
        raise ValueError(f"gather_interp_generic: {V} species at K={K}, "
                         f"kernel takes 1..{MAX_V}")
    _check("u", u, dev, dt, (V, N))
    _check("conn_T", conn_T, dev, torch.int32, (K, E))
    _check("dphi", dphi, dev, dt, (Q, K, 3, E))
    ph = _phi_host(phi, Q, K)
    ph_dev = _phi_dev(ph, dt, dev)
    u_qp = torch.empty((V, Q, E), dtype=dt, device=dev)
    gx = torch.empty((V, Q, 3, E), dtype=dt, device=dev)
    with _on_device(dev):
        _launch(variant, _fn(variant), _ptr(u), _ptr(conn_T), _host(ph),
                _ptr(ph_dev), _ptr(dphi), _ptr(u_qp), _ptr(gx), V, N, K, Q,
                E, _stream(dev), instance=f"{variant}:{elem}")
    return u_qp, gx


def rhs_affine(st: RhsStacks, JxW: torch.Tensor, phi, dphi0: torch.Tensor):
    """K2: stacked A/B blocks, JxW (Q, E) f32 or f64, phi (Q, K) host
    table, dphi0 (K, 3, E) and the blocks in JxW's dtype -> Fe (V, K, E)."""
    if _on_cpu(JxW):
        return rhs_affine_plain(st, JxW, phi, dphi0)
    V = st.n_vars
    Q, E = JxW.shape
    K = dphi0.shape[0]
    dev, dt = JxW.device, JxW.dtype
    variant = "rhs_affine_" + _float_tag("rhs_affine", dt)
    if not 1 <= V <= MAX_V:
        raise ValueError(f"rhs_affine: {V} species, kernel takes 1..{MAX_V}")
    elem = _check_affine_kq("rhs_affine", K, Q)
    _check("JxW", JxW, dev, dt, (Q, E))
    _check("dphi0", dphi0, dev, dt, (K, 3, E))
    _check("A", st.A, dev, dt, (len(st.idxA), Q, E))
    _check("B", st.B, dev, dt, (len(st.idxB), Q, 3, E))
    slots = np.full((2, MAX_V), -1, np.int32)
    slots[0, st.idxA] = np.arange(len(st.idxA))
    slots[1, st.idxB] = np.arange(len(st.idxB))
    ph = _phi_host(phi, Q, K)
    Fe = torch.empty((V, K, E), dtype=dt, device=dev)
    with _on_device(dev):
        _launch(variant, _fn(variant), _ptr(st.A), _ptr(st.B), _host(slots),
                _ptr(JxW), _host(ph), _ptr(dphi0), _ptr(Fe), V, K, Q, E,
                _stream(dev), instance=f"{variant}:{elem}")
    return Fe


class ApplyLaunchData(NamedTuple):
    """What a K3 ("affine") or K6 ("generic") launch takes besides x, for
    one set of stacks with the element tables: the checked shapes, the
    (3, MAX_V, MAX_V) int32 slot table and the (Q, K) f64 phi table."""

    V: int
    N: int
    K: int
    Q: int
    E: int
    dtype: torch.dtype
    device: torch.device
    slots: np.ndarray
    phi: np.ndarray


def apply_launch_data(kind: str, conn_T: torch.Tensor, phi,
                      JxW: torch.Tensor, dphi: torch.Tensor, st,
                      N: int) -> ApplyLaunchData:
    """Check the tensors a K3 or K6 launch keeps for a step, on any device:
    conn_T (K, E) int32; JxW (Q, E) f32 or f64, and in its dtype and on its
    device dphi (K, 3, E) (affine) or (Q, K, 3, E) (generic) and the
    stacks (ApplyStacks or GenericApplyStacks); phi (Q, K); x will be
    (V, N).  Raises TypeError on a wrong dtype, ValueError on a wrong
    device, shape or contiguity."""
    generic = kind == "generic"
    name = "apply_generic" if generic else "apply_affine"
    V, dev, dt = st.n_vars, JxW.device, JxW.dtype
    _float_tag(name, dt)
    if not 1 <= V <= MAX_V:
        raise ValueError(f"{name}: {V} species, kernel takes 1..{MAX_V}")
    if conn_T.dim() != 2 or JxW.dim() != 2:
        raise ValueError(f"{name}: conn_T {tuple(conn_T.shape)} and JxW "
                         f"{tuple(JxW.shape)} must be (K, E) and (Q, E)")
    K, E = conn_T.shape
    Q = JxW.shape[0]
    if generic:
        _check_kq(name, K, Q)
    else:
        _check_affine_kq(name, K, Q)
    _check("conn_T", conn_T, dev, torch.int32, (K, E))
    _check("JxW", JxW, dev, dt, (Q, E))
    _check("dphi", dphi, dev, dt, (Q, K, 3, E) if generic else (K, 3, E))
    _check("C", st.C, dev, dt, (len(st.idxC), Q, E))
    _check("D", st.D, dev, dt, (len(st.idxD), Q, 3, E))
    if generic:
        _check("E", st.E, dev, dt, (len(st.idxE), Q, E))
    else:
        _check("Epre", st.Epre, dev, dt, (len(st.idxE), E))
    return ApplyLaunchData(V, N, K, Q, E, dt, dev, _apply_slots(st),
                           _phi_host(phi, Q, K))


class _ApplyPlan(NamedTuple):
    variant: str
    instance: str  # "<variant>:<element type>"
    fn: Callable
    ptr: int
    buf: ctypes.Array
    device: torch.device
    dtype: torch.dtype
    x_shape: tuple
    out_shape: tuple
    tables: tuple  # the element tables the plan points into, kept alive


def _apply_plan(kind: str, x: torch.Tensor, conn_T, phi, JxW, dphi,
                st) -> _ApplyPlan:
    """The K3/K6 plan of stacks `st` with these element tables: from
    st.plans, else checked, made and kept there."""
    plans = st.plans if st.plans is not None else {}
    key = (id(conn_T), id(phi), id(JxW), id(dphi))
    p = plans.get(key)
    if p is not None:
        return p
    d = apply_launch_data(kind, conn_T, phi, JxW, dphi, st, x.shape[-1])
    tag = _TAG[d.dtype]
    generic = kind == "generic"
    extra = ((len(st.idxC), len(st.idxD), len(st.idxE)) if generic else ())
    Ep = st.E if generic else st.Epre
    # K6 reads a device copy of phi where it is too large to ride in the
    # kernel parameters
    ph_dev = _phi_dev(d.phi, d.dtype, d.device) if generic else None
    buf, ptr = _plan(f"apply_{kind}_plan", _ptr(conn_T), _ptr(JxW),
                     _ptr(dphi), _ptr(st.C), _ptr(st.D), _ptr(Ep),
                     _host(d.slots), _host(d.phi),
                     *((_ptr(ph_dev),) if generic else ()), d.V, d.N, d.K,
                     d.Q, d.E, *extra, JxW.element_size(), d.device.index)
    variant = f"apply_{kind}_{tag}"
    elem = (GENERIC_KQ if generic else AFFINE_KQ)[(d.K, d.Q)]
    p = _ApplyPlan(variant, f"{variant}:{elem}", _fn(variant), ptr, buf,
                   d.device, d.dtype, (d.V, d.N), (d.V, d.K, d.E),
                   (conn_T, phi, JxW, dphi, ph_dev))
    plans[key] = p
    return p


def _apply(kind: str, x, conn_T, phi, JxW, dphi, st) -> torch.Tensor:
    p = _apply_plan(kind, x, conn_T, phi, JxW, dphi, st)
    _check_fast("x", x, p.device, p.dtype, p.x_shape)
    Ye = x.new_empty(p.out_shape)
    _launch(p.variant, p.fn, p.ptr, x.data_ptr(), Ye.data_ptr(),
            _stream(p.device), instance=p.instance)
    return Ye


def apply_affine(x: torch.Tensor, conn_T: torch.Tensor, phi,
                 JxW: torch.Tensor, dphi0: torch.Tensor, st: ApplyStacks):
    """K3: x (V, N) f32 or f64, conn_T (K, E) int32, phi (Q, K) host
    table, JxW (Q, E), dphi0 (K, 3, E) and the stacked blocks, all in x's
    dtype -> Ye (V, K, E)."""
    if _on_cpu(x):
        return apply_affine_plain(x, conn_T, phi, JxW, dphi0, st)
    return _apply("affine", x, conn_T, phi, JxW, dphi0, st)


def apply_generic(x: torch.Tensor, conn_T: torch.Tensor, phi,
                  JxW: torch.Tensor, dphi: torch.Tensor,
                  st: GenericApplyStacks):
    """K6: x (V, N) f32 or f64, conn_T (K, E) int32, phi (Q, K) host
    table, JxW (Q, E), dphi (Q, K, 3, E) and the stacked blocks, all in x's
    dtype -> Ye (V, K, E)."""
    if _on_cpu(x):
        return apply_generic_plain(x, conn_T, phi, JxW, dphi, st)
    return _apply("generic", x, conn_T, phi, JxW, dphi, st)


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
    with _on_device(dev):
        _launch("take_along_f32", _fn("take_along_f32"), _ptr(tbl),
                _ptr(idx), _ptr(out), S, M, L, _stream(dev))
    return out


def restrict_table(node_gather: torch.Tensor):
    """Check a K4 gather table on any device: (C, N) int32, contiguous.
    Returns (C, N); raises TypeError on a wrong dtype, ValueError on a
    wrong shape or contiguity."""
    if node_gather.dtype != torch.int32:
        raise TypeError(f"node_gather: dtype {node_gather.dtype}, expected "
                        f"torch.int32")
    if node_gather.dim() != 2:
        raise ValueError(f"node_gather: shape {tuple(node_gather.shape)}, "
                         f"expected (C, N)")
    if not node_gather.is_contiguous():
        raise ValueError("node_gather: not contiguous")
    C, N = node_gather.shape
    return C, N


class _TablePlan(NamedTuple):
    ptr: int
    buf: ctypes.Array
    table: weakref.ref
    N: int
    device: torch.device


_RESTRICT = {dt: f"restrict_{tag}" for dt, tag in _TAG.items()}
_table_plans: Dict[int, _TablePlan] = {}


def _table_plan(node_gather: torch.Tensor) -> _TablePlan:
    """K4's plan of a gather table: kept by the table's identity while the
    table lives, made (and the table checked) on its first launch."""
    p = _table_plans.get(id(node_gather))
    if p is not None and p.table() is node_gather:
        return p
    C, N = restrict_table(node_gather)
    if node_gather.device.type != "cuda":
        raise ValueError(f"node_gather: on {node_gather.device}, expected "
                         f"a CUDA device")
    buf, ptr = _plan("restrict_plan", _ptr(node_gather), C, N,
                     node_gather.device.index)
    key = id(node_gather)
    ref = weakref.ref(node_gather, lambda _, key=key: _table_plans.pop(key,
                                                                      None))
    p = _TablePlan(ptr, buf, ref, N, node_gather.device)
    _table_plans[key] = p
    return p


def restrict(flat: torch.Tensor, node_gather: torch.Tensor) -> torch.Tensor:
    """K4: flat (W, K*E) f32 or f64, node_gather (C, N) int32 (pad = K*E)
    -> y (W, N)."""
    if _on_cpu(flat):
        return restrict_plain(flat, node_gather)
    variant = _RESTRICT.get(flat.dtype)
    if variant is None:
        raise TypeError(f"restrict: no kernel for {flat.dtype}")
    if flat.dim() != 2:
        raise ValueError(f"flat: shape {tuple(flat.shape)}, expected "
                         f"(W, K*E)")
    p = _table_plan(node_gather)
    _check_fast("flat", flat, p.device, flat.dtype, flat.shape)
    W, KE = flat.shape
    y = flat.new_empty((W, p.N))
    _launch(variant, _fn(variant), p.ptr, flat.data_ptr(), y.data_ptr(), W,
            KE, _stream(p.device))
    return y


def ell_matvec(values_ell: torch.Tensor, ell_cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """K5: values_ell (V, W, L, N) f32 or f64, ell_cols (L, N) int32, x
    (W, N) in values' dtype -> y (V, N)."""
    if _on_cpu(values_ell):
        return ell_matvec_plain(values_ell, ell_cols, x)
    V, W, L, N = values_ell.shape
    dev, dt = values_ell.device, values_ell.dtype
    variant = "ell_matvec_" + _float_tag("ell_matvec", dt)
    if not 1 <= W <= MAX_V:
        raise ValueError(f"ell_matvec: {W} columns per block, kernel takes "
                         f"1..{MAX_V}")
    _check("values_ell", values_ell, dev, dt, (V, W, L, N))
    _check("ell_cols", ell_cols, dev, torch.int32, (L, N))
    _check_fast("x", x, dev, dt, (W, N))
    y = values_ell.new_empty((V, N))
    with _on_device(dev):
        _launch(variant, _fn(variant), _ptr(values_ell),
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
