"""Transient linearized-Crank-Nicolson RDC system (port of
rdcfes_tpu.systems.transient for single-type meshes: TET4, HEX8, TET10,
HEX20, HEX27 and the 2D TRI3, QUAD4, QUAD8, QUAD9; systems/mixed.py runs
the same step on a MixedMesh).  Two paths, the reference's: the
matrix-free qp path of a block form (`physics_blocks`), described first,
and the dense element-matrix path of a `physics=` WeakForm, described
at the end.

Per time step, as in the reference app's TransientLinearImplicitSystem
use (src/pihna.C:66-93):
  1. rotate history (older <- old <- current);
  2. gather u to element corners and interpolate to quadrature points,
     evaluate the coefficient blocks, build the element right-hand side
     and restrict it to the nodal b (K4).  TET4 is affine (one gradient
     per element): K1 gathers and interpolates, K2 builds the
     right-hand side.  HEX8 and TET10 have per-q gradients: K8 gathers
     and interpolates, and fem.weakform.block_rhs, plain tensor code as
     in the reference, builds the right-hand side, once per step;
  3. every `precond_refresh` steps, restrict the per-element (i, i)
     blocks to the block-Jacobi diagonal (K4) and invert it;
  4. solve: mixed-precision iterative refinement (f32 BiCGStab passes with
     f64 residual correction and an f64 rescue) or, with precision="f64",
     BiCGStab or GMRES in f64.  Every matvec is the gather + element
     apply, K3 on TET4 and K6 on the others, followed by K4;
  5. clamp at zero (`check_solution`, src/pihna.C:760-803).

The element-type specific part of steps 2-4 is an `ElementBlock`: its
connectivity, its phi table and the calls of its kernels.  A single-type
mesh is one block; a MixedMesh (systems/mixed.py) one per type, whose
corner values are concatenated in block order and restricted by one K4
launch through one table (fem.assembly.block_node_gather), so every
node's sum runs in the same order in every run.

With `constraints=` (rows [h, a, b]: u_h = (u_a + u_b) / 2, the hanging
nodes of a 1:8-refined mesh, mesh/constrain.py) the solve runs on the
constrained operator C^T A C inside full vectors, as the reference's
does (rdcfes_tpu/systems/transient.py:619-634): `c_apply` gives every
hanging entry its masters' mean before each element apply, `ct_fold`
folds the hanging rows onto their two masters after every restriction
and on b, the block-Jacobi diagonal takes the folded quarter blocks and
an identity on the hanging rows, the Krylov vectors keep zeros there,
and the solved and the clamped u get `c_apply` again.  The algebra is
fem/constraints.Constraints, which the solid's Newton shares (no
atomics, so the step stays bit-equal from run to run).

Every stage of a step reads one geometry record (JxW, the shape
gradients and their f32 casts).  On a fixed mesh it is the rest
geometry, built once; with moving_mesh=True, `step` and `run_steps`
build it from the coords they are given (the coupled HCC driver's
deformed positions), the role of the reference app's fe->reinit on the
moved mesh (src/coupled_hcc.C:114).

dtype=torch.float32 is the reference's serving mode (rdcfes_tpu/systems/
transient.py:231-238): the state, the geometry (computed in f64, then
cast), the coefficient blocks, the block-Jacobi inverse, the Krylov
solve, the constraints and the dense path's Fe, Ke and diagonal are all
f32, through the f32 instances of K1, K2 and K8 and the f32 K3, K4 and
K6.  The rtol is floored at 1e-6, and precision="mixed" runs the plain
Krylov solve (refine_mixed refines an f32 solve against f64, which an
f32 system does not have).

Layouts are channel-first inside (u is (V, N)); the public state keeps the
reference's (N, V) arrays.  PyTorch runs eagerly, so the step is plain
Python: the reference's jit/scan machinery has no counterpart here.

The dense path (rdcfes_tpu/systems/transient.py:435-561) serves a
`physics` callable that returns a dense fem.weakform.WeakForm: `step`
takes it when the system has no block form or a param is not a plain
number, as the reference's dispatch does (:1245-1272).  Per step each
block's u is gathered and interpolated (K1 or K8), the physics gives the
WeakForm, fem.weakform.element_vectors and element_matrices (plain
torch, as the reference leaves them to XLA) give Fe (V, K, E), the
element matrices Ke (V, V, K, K, E) and their (i, i) blocks; K4
restricts Fe to b and the diagonal blocks to the block-Jacobi diagonal,
and every matvec applies Ke per element (one batched product) and
restricts the result with K4.  `assemble` restricts Ke onto the
(V, V, nnz) values of the node-pair sparsity with K4 over its slot table
(W = V * V), as the solid's tangent is assembled.  On a moving mesh the
dense step rebuilds the geometry and the inverse from `coords` every
call (the reference's _step_moving).  The reference's dense path applies
no hanging-node constraints (its _solve_clamped ignores them), and
neither does this one: `constraints=` acts on the qp path only.
`run_steps` needs the block form, as the reference's does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..fem import elements
from ..fem.assembly import (block_node_gather, build_sparsity,
                            build_sparsity_mixed, invert_scatter)
from ..fem.constraints import Constraints  # noqa: F401 (re-exported)
from ..fem.geometry import geometry_factors
from ..fem.kernels import (KERNEL_OPS, Ops, stack_apply, stack_apply_generic,
                           stack_rhs)
from ..fem.weakform import (block_diag, block_diag_affine, block_rhs,
                            diffusion_presum, element_matrices,
                            element_vectors)
from ..mesh.core import Mesh
from ..solvers.krylov import (DEFAULT_MAXITER, DEFAULT_RTOL, _dot,
                              apply_block_jacobi, bicgstab, gmres,
                              small_block_inverse)
from ..utils.convert import state_from_numpy, state_to_numpy
from ..utils.device import cuda_device

# TET4 and TRI3 affine (K1-K3); the others generic (K8, K6 at their
# (K, Q))
_AFFINE_TYPES = ("TET4", "TRI3")
_ELEMENT_TYPES = ("TET4", "HEX8", "TET10", "HEX20", "HEX27", "TRI3",
                  "QUAD4", "QUAD8", "QUAD9")
_METHODS = {"bicgstab": bicgstab, "gmres": gmres}


class Geometry(NamedTuple):
    """The coordinate-dependent tables of a step.  dphi is what the
    kernels take: one gradient per element, dphi[0] (K, 3, E), on the
    affine (TET4, TRI3) path (q-invariant there), the per-q tables
    (Q, K, 3, E) on the other types."""
    JxW: torch.Tensor      # (Q, E) in the system's dtype
    dphi: torch.Tensor     # in the system's dtype
    JxW32: torch.Tensor    # the f32 casts of the inner matvec (the same
    dphi32: torch.Tensor   # tensors in an f32 system)


class ElementBlock:
    """The elements of one type in a system: connectivity, phi and the
    kernel calls of a step's element stages.  TET4 and TRI3 are affine:
    K1, K2, K3, with dphi one gradient per element (K, 3, E); the other
    types run K8, fem.weakform.block_rhs and K6 on the per-q dphi
    (Q, K, 3, E)."""

    def __init__(self, elem_type: str, conn: np.ndarray, device):
        self.elem_type = elem_type
        self.affine = elem_type in _AFFINE_TYPES
        # a copy in torch's own (aligned) memory: a view of a numpy array
        # may start off the alignment of torch's vectorized CPU gathers
        self.conn_T = torch.tensor(np.ascontiguousarray(conn.T),
                                   device=device)
        self.phi = elements.tabulate(elem_type)[0]  # coordinate-free

    def geometry(self, coords: torch.Tensor,
                 dtype: torch.dtype = torch.float64) -> Geometry:
        """The block's Geometry at node positions coords (N, 3) f64,
        computed in f64 and cast to dtype (the reference's JxW.astype,
        rdcfes_tpu/systems/transient.py:275-276)."""
        _, JxW, dphi = geometry_factors(coords, self.conn_T.T,
                                        self.elem_type)
        if self.affine:
            dphi = dphi[0].clone()  # one gradient per element
        JxW, dphi = JxW.to(dtype), dphi.to(dtype)
        return Geometry(JxW, dphi, JxW.to(torch.float32),
                        dphi.to(torch.float32))

    def interp(self, ops: Ops, u_T: torch.Tensor, g: Geometry):
        """u_T (V, N) -> (u_qp (V, Q, E), grad_qp (V, Q, 3, E))."""
        if self.affine:
            u_qp, gx1 = ops.gather_interp_affine(u_T, self.conn_T, self.phi,
                                                 g.dphi)
            # one gradient per element, broadcast over q for the physics
            return u_qp, gx1[:, None].expand(gx1.shape[0], u_qp.shape[1],
                                             3, gx1.shape[-1])
        return ops.gather_interp_generic(u_T, self.conn_T, self.phi, g.dphi)

    def rhs(self, ops: Ops, wfb, g: Geometry) -> torch.Tensor:
        """The element right-hand side Fe (V, K, E)."""
        if self.affine:
            return ops.rhs_affine(stack_rhs(wfb), g.JxW, self.phi, g.dphi)
        return block_rhs(wfb, self.phi, g.JxW, g.dphi)

    def diag(self, wfb, g: Geometry) -> torch.Tensor:
        """The element (i, i) blocks (V, V, K, E) of the block-Jacobi
        diagonal."""
        if self.affine:
            return block_diag_affine(wfb, self.phi, g.JxW, g.dphi[None])
        return block_diag(wfb, self.phi, g.JxW, g.dphi)

    def stacks(self, wfb, JxW: torch.Tensor):
        """The operator's stacked live blocks in wfb's dtype (JxW in the
        same dtype); on the affine path with the diffusion q-sum that
        every matvec reuses."""
        if self.affine:
            return stack_apply(wfb, diffusion_presum(wfb, JxW))
        return stack_apply_generic(wfb)

    def apply(self, ops: Ops, x: torch.Tensor, st, JxW: torch.Tensor,
              dphi: torch.Tensor) -> torch.Tensor:
        """The gather + element apply of x (V, N) -> Ye (V, K, E)."""
        fn = ops.apply_affine if self.affine else ops.apply_generic
        return fn(x, self.conn_T, self.phi, JxW, dphi, st)

    # the dense path
    def element_kernels(self, wf, g: Geometry):
        """(Fe (V, K, E), Ke (V, V, K, K, E), diag_e (V, V, K, E)) of a
        dense WeakForm (the reference's _element_kernels: the affine types
        take element_matrices' grad_const route)."""
        dphi = g.dphi
        if self.affine:
            dphi = dphi[None].expand((len(self.phi),) + tuple(dphi.shape))
        Fe = element_vectors(wf, self.phi, g.JxW, dphi)
        Ke, diag_e = element_matrices(wf, self.phi, g.JxW, dphi,
                                      grad_const=self.affine,
                                      return_diag=True)
        dt = g.JxW.dtype
        # physics code may build f64 constants (the reference's comment,
        # rdcfes_tpu/systems/transient.py:466-467): the system's dtype wins
        return Fe.to(dt), Ke.to(dt), diag_e.to(dt)

    @staticmethod
    def batched(Ke: torch.Tensor) -> torch.Tensor:
        """Ke (V, W, K, K, E) as (E, V K, W K): one matrix per element,
        rows (v, i), columns (w, j), the layout `dense_apply` multiplies."""
        V, W, K, _, E = Ke.shape
        return Ke.permute(4, 0, 2, 1, 3).reshape(E, V * K, W * K)

    def dense_apply(self, KeB: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
        """Ye[v, i, e] = sum_{w, j} Ke[v, w, i, j, e] x[w, conn[e, j]]:
        the gather and one batched product (the reference's
        _elem_matvec), x (W, N) in KeB's dtype -> Ye (V, K, E)."""
        W = x.shape[0]
        K, E = self.conn_T.shape
        ue = x[:, self.conn_T].permute(2, 0, 1).reshape(E, W * K, 1)
        ye = torch.bmm(KeB, ue)  # (E, V K, 1)
        return ye.reshape(E, -1, K).permute(1, 2, 0)


def clamp_nonnegative(u: torch.Tensor) -> torch.Tensor:
    """Default post-solve clamp: every species >= 0 (src/pihna.C:786-790)."""
    return torch.clamp(u, min=0.0)


def refine_mixed(mv32: Callable, pre_matvec64: Callable,
                 pre_b: torch.Tensor, x0: torch.Tensor, rtol: float,
                 maxiter: int, inner_rtol: float = 1e-6,
                 adaptive_tol: bool = True):
    """Mixed-precision iterative refinement: f32 BiCGStab passes on the
    preconditioned operator, f64 residual correction (the reference's
    refine_mixed, systems/transient.py:78-186).

    * pass 0 solves the full system in f32 from the warm start x0, to
      max(rtol, 3e-7), and applies its exact f32 correction to the f64 x0;
    * each later pass solves the residual equation to eps_k =
      clip(0.25 tol / |r|, inner_rtol, 0.1) (adaptive_tol) or inner_rtol,
      at most 80 f32 iterations a pass and 12 passes in all;
    * the loop also stops on stagnation, when a pass fails to halve |r|;
    * a residual still above tol is finished by an f64 BiCGStab on
      pre_matvec64 (the reference's f64_fallback, which all its callers
      turn on).

    Returns (x, inner iterations, final |r| / |b| as a 0-d tensor)."""
    f32, f64 = torch.float32, torch.float64
    bnorm = torch.sqrt(_dot(pre_b, pre_b))
    safe_b = torch.where(bnorm == 0.0, 1.0, bnorm)
    tol = rtol * safe_b

    x0_32 = x0.to(f32)
    inner0 = bicgstab(mv32, pre_b.to(f32), x0=x0_32, rtol=max(rtol, 3e-7),
                      maxiter=80)
    x = x0 + (inner0.x - x0_32).to(f64)
    r = pre_b - pre_matvec64(x)
    rnorm = torch.sqrt(_dot(r, r))
    prev = torch.full_like(rnorm, math.inf)
    iters, k = inner0.iters, 1
    while k < 12 and bool((rnorm > tol) & (rnorm < 0.5 * prev)):
        if adaptive_tol:
            eps_k = torch.clamp(0.25 * tol / rnorm, inner_rtol, 1e-1).to(f32)
        else:
            eps_k = inner_rtol
        inner = bicgstab(mv32, r.to(f32), rtol=eps_k, maxiter=80)
        x = x + inner.x.to(f64)
        r = pre_b - pre_matvec64(x)
        prev, rnorm = rnorm, torch.sqrt(_dot(r, r))
        iters += inner.iters
        k += 1
    if bool(rnorm > tol):
        res = bicgstab(pre_matvec64, pre_b, x0=x, rtol=rtol, maxiter=maxiter)
        return res.x, iters + res.iters, res.residual
    return x, iters, rnorm / safe_b


class TransientRDCSystem:
    """A transient multi-species RDC system on a single-type mesh (TET4,
    HEX8, TET10, HEX20, HEX27, or the 2D TRI3, QUAD4, QUAD8, QUAD9), fixed
    or moving, stepped on the matrix-free qp path or the dense
    element-matrix path.

    mesh            : host Mesh (TET4 and TRI3: the affine path; the
                      others the generic path with per-q shape gradients)
    n_vars          : number of coupled nodal variables V
    physics_blocks  : callable(u_qp (V,Q,E), grad_qp (V,Q,3,E), fields,
                      params) -> WeakFormBlocks (e.g. models.pihna,
                      models.adpm), the qp path's form; or None
    physics         : callable of the same arguments -> a dense WeakForm
                      (e.g. models.pihna.pihna_physics), the dense path's
                      form (keyword; the reference's third argument); at
                      least one of the two is required
    clamp           : callable(u (V,N)) -> (V,N), applied after each solve
    rtol, maxiter   : linear tolerance on the preconditioned residual
                      (floored at 1e-6 in f32), and the iteration cap of
                      the f64 solve or rescue
    precision       : "f64" (the default: one Krylov solve with `method`)
                      or "mixed" (f32 BiCGStab passes, f64 refinement; an
                      f32 system runs the plain solve)
    dtype           : torch.float64 (the default) or torch.float32, the
                      reference's serving mode: state, geometry, blocks,
                      operators and the solve in f32
    method          : "bicgstab" or "gmres", the f64 solver of
                      precision="f64"
    precond_refresh : recompute the block-Jacobi inverse every k steps
    constraints     : (H, 3) rows [h, a, b], the hanging nodes u_h =
                      (u_a + u_b) / 2 of mesh/constrain.ConstrainedMesh,
                      or None
    moving_mesh     : the geometry follows the `coords` (N, 3) that step
                      and run_steps are given (required then); on a fixed
                      mesh `coords` is ignored, as in the reference
    device          : where the tables and the state live; None (the
                      default) is the CUDA card (utils.device.cuda_device,
                      which raises without one: never the CPU)
    ops             : fem.kernels.KERNEL_OPS (default) or PLAIN_OPS, the
                      plain torch versions of the same operations

    `fields` of step/run_steps: tensors on the system's device (ADPM's
    "tracts" (E, 3)) and Python floats ("time").  `step` takes the qp
    path when physics_blocks is given and every param is a plain number,
    the dense path otherwise.
    """

    # refine_mixed's inner-pass settings (its defaults here)
    _refine_kw: Dict = {}

    def __init__(self, mesh: Mesh, n_vars: int,
                 physics_blocks: Optional[Callable] = None,
                 clamp: Callable = clamp_nonnegative,
                 rtol: float = DEFAULT_RTOL,
                 maxiter: int = DEFAULT_MAXITER, precision: str = "f64",
                 precond_refresh: int = 1,
                 constraints: Optional[np.ndarray] = None,
                 moving_mesh: bool = False, device=None,
                 ops: Ops = KERNEL_OPS, method: str = "bicgstab",
                 physics: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float64):
        if mesh.elem_type not in _ELEMENT_TYPES:
            raise ValueError(
                f"{mesh.elem_type} meshes in TransientRDCSystem (a "
                f"MixedMesh goes to systems.mixed.MixedTransientRDCSystem)")
        self._setup(mesh, [(mesh.elem_type, mesh.connectivity)], n_vars,
                    physics_blocks, clamp, rtol, maxiter, precision,
                    precond_refresh, device, ops, method, physics, dtype)
        dev = self.device
        self.moving_mesh = bool(moving_mesh)
        self.cons = (Constraints(constraints, dev)
                     if constraints is not None and len(constraints)
                     else None)
        blk = self.blocks[0]
        self.affine, self.conn_T, self.phi = blk.affine, blk.conn_T, blk.phi
        self.geom = self.geoms[0]

    def _setup(self, mesh, element_blocks, n_vars, physics_blocks, clamp,
               rtol, maxiter, precision, precond_refresh, device, ops,
               method, physics, dtype) -> None:
        """What every system keeps: the settings, one ElementBlock per
        (elem_type, connectivity) in the global element order, their
        rest geometries and the one K4 table over their corners."""
        if physics_blocks is None and physics is None:
            raise ValueError("a transient system needs physics_blocks (a "
                             "WeakFormBlocks callable) or physics= (a "
                             "WeakForm callable)")
        if precision not in ("f64", "mixed"):
            raise ValueError(f"unknown precision {precision!r}")
        if method not in _METHODS:
            raise ValueError(f"unknown method {method!r}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype!r}: a transient system runs in "
                             f"torch.float32 or torch.float64")
        if dtype == torch.float32:
            # f32 limits the reachable relative residual to ~1e-6
            rtol = max(rtol, 1e-6)
        self.dtype = dtype
        self.mesh = mesh
        self.method = method
        self.n_vars = n_vars
        self.physics_blocks = physics_blocks
        self.physics = physics
        self.clamp = clamp
        self.rtol = rtol
        self.maxiter = maxiter
        self.precision = precision
        self.precond_refresh = int(precond_refresh)
        self.device = cuda_device() if device is None else torch.device(device)
        self.ops = ops
        self.moving_mesh = False
        self.cons = None
        self._dinv_cache = None
        self._steps_since_precond = 0
        self._slot_gather = None  # assemble's K4 table, made at first use
        dev = self.device
        self.blocks = [ElementBlock(t, conn, dev) for t, conn in element_blocks]
        self.node_gather = torch.as_tensor(
            block_node_gather([c for _, c in element_blocks], mesh.n_nodes),
            device=dev)
        # the rest geometry of each block; a moving mesh's step and
        # run_steps build theirs from the coords they are given
        self.geoms = self._geoms_from_coords(mesh.coords)

    def _geoms_from_coords(self, coords):
        """Each block's geometry record at node positions coords (N, 3)
        (the reference's _geom_from_coords, rdcfes_tpu/systems/
        transient.py:1202-1222); phi does not depend on them."""
        coords = torch.as_tensor(coords, dtype=torch.float64,
                                 device=self.device)
        return [blk.geometry(coords, self.dtype) for blk in self.blocks]

    def _geom_from_coords(self, coords) -> Geometry:
        """The one block's geometry record at node positions coords."""
        return self._geoms_from_coords(coords)[0]

    def _moving_geoms(self, coords):
        """The blocks' geometries of a step or run_steps call: built from
        coords on a moving mesh, None (the rest geometries) on a fixed
        one."""
        if not self.moving_mesh:
            return None
        if coords is None:
            raise ValueError("a moving_mesh system needs the current "
                             "coords")
        return self._geoms_from_coords(coords)

    # ------------------------------------------------------------------
    def initial_state(self, u0) -> Dict[str, torch.Tensor]:
        u0 = torch.as_tensor(u0, dtype=self.dtype, device=self.device)
        if tuple(u0.shape) != (self.mesh.n_nodes, self.n_vars):
            raise ValueError(f"u0 shape {tuple(u0.shape)}, expected "
                             f"{(self.mesh.n_nodes, self.n_vars)}")
        # u_raw = the pre-clamp solver output (RIPF's bookkeeping uses it)
        return {"u": u0, "u_old": u0, "u_older": u0, "u_raw": u0}

    def gather_state(self, state: Dict) -> Dict[str, np.ndarray]:
        return state_to_numpy(state)

    def gather(self, u: torch.Tensor) -> np.ndarray:
        """A state entry (N, V) as a host array (what the multi-device
        system's gather gives from its shards)."""
        return u.detach().cpu().numpy()

    def scatter_state(self, gstate: Dict) -> Dict[str, torch.Tensor]:
        return state_from_numpy(gstate, self.device, self.dtype)

    # ------------------------------------------------------------------
    def _fields_for_block(self, bi: int, fields: Dict) -> Dict:
        """The fields block bi's physics sees: on one block, `fields`."""
        return fields

    def _restrict(self, parts, W: int, table=None) -> torch.Tensor:
        """K4 of the blocks' corner values parts[b] (..., K_b, E_b),
        flattened to (W, K_b E_b) and concatenated in block order, through
        `table` (default the node table)."""
        flat = [p.reshape(W, -1) for p in parts]
        flat = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
        return self.ops.restrict(flat, self.node_gather if table is None
                                 else table)

    def _matvec(self, x, stacks, geoms, f32: bool):
        """Matrix-free operator: each block's gather + element apply (K3
        with the element's one gradient table on TET4, K6 with the per-q
        tables on the others), then K4; with constraints C^T A C."""
        if self.cons is not None:
            x = self.cons.c_apply(x)
        Ye = [blk.apply(self.ops, x, st, g.JxW32 if f32 else g.JxW,
                        g.dphi32 if f32 else g.dphi)
              for blk, st, g in zip(self.blocks, stacks, geoms)]
        y = self._restrict(Ye, self.n_vars)
        return y if self.cons is None else self.cons.ct_fold(y)

    def _step_body(self, state, fields, params, Dinv, geoms=None):
        """One qp step (the reference's _qp_raw_body step_fn) on the
        blocks' geometries `geoms` (None: the rest geometries).  Dinv
        None = build a fresh block-Jacobi inverse.  Returns (new_state,
        inner iterations, residual, Dinv)."""
        V, N = self.n_vars, self.mesh.n_nodes
        ops = self.ops
        f32 = torch.float32
        geoms = self.geoms if geoms is None else geoms
        u_T = state["u"].T.contiguous()
        wfbs = []
        for bi, (blk, g) in enumerate(zip(self.blocks, geoms)):
            u_qp, grad_qp = blk.interp(ops, u_T, g)
            # blocks that met f64 fields or constants come back in the
            # system's dtype (a no-op where they are already)
            wfbs.append(self.physics_blocks(
                u_qp, grad_qp, self._fields_for_block(bi, fields),
                params).cast(self.dtype))
        b = self._restrict([blk.rhs(ops, wfb, g) for blk, wfb, g
                            in zip(self.blocks, wfbs, geoms)], V)
        cons = self.cons
        if cons is not None:
            b = cons.ct_fold(b)
        if Dinv is None:
            D = self._restrict([blk.diag(wfb, g) for blk, wfb, g
                                in zip(self.blocks, wfbs, geoms)],
                               V * V).reshape(V, V, N)
            if cons is not None:
                D = cons.fold_diagonal(D)
            Dinv = small_block_inverse(D, pivot=False)
        st64 = [blk.stacks(wfb, g.JxW)
                for blk, wfb, g in zip(self.blocks, wfbs, geoms)]
        pre_matvec = lambda x: apply_block_jacobi(
            Dinv, self._matvec(x, st64, geoms, False))
        pre_b = apply_block_jacobi(Dinv, b)
        # linear extrapolation warm start
        x0 = (2.0 * state["u"] - state["u_old"]).T.contiguous()
        if cons is not None:
            x0 = cons.pin(x0)  # iterate on the masters: hanging entries 0
        if self._refines():
            # the f32 operator is built from f32 casts of the f64 blocks,
            # its diffusion q-sum taken in f32 (the reference's wfb.cast)
            st32 = [blk.stacks(wfb.cast(f32), g.JxW32)
                    for blk, wfb, g in zip(self.blocks, wfbs, geoms)]
            Dinv32 = Dinv.to(f32)
            mv32 = lambda x: apply_block_jacobi(
                Dinv32, self._matvec(x, st32, geoms, True))
            u_raw, iters, resid = refine_mixed(mv32, pre_matvec, pre_b, x0,
                                               self.rtol, self.maxiter,
                                               **self._refine_kw)
        else:
            r = _METHODS[self.method](pre_matvec, pre_b, x0=x0,
                                      rtol=self.rtol, maxiter=self.maxiter)
            u_raw, iters, resid = r.x, r.iters, r.residual
        if cons is not None:
            # the hanging values follow the solved masters, and again
            # the clamped ones
            u_raw = cons.c_apply(u_raw)
            u_new = cons.c_apply(self.clamp(u_raw))
        else:
            u_new = self.clamp(u_raw)
        new_state = {"u": u_new.T, "u_old": state["u"],
                     "u_older": state["u_old"], "u_raw": u_raw.T}
        return new_state, iters, resid, Dinv

    def _refines(self) -> bool:
        """Whether the solve is refine_mixed: precision="mixed" in f64 (an
        f32 system runs the plain Krylov solve, rdcfes_tpu/systems/
        transient.py:521)."""
        return self.precision == "mixed" and self.dtype == torch.float64

    # ------------------------------------------------------------------
    # the dense element-matrix path
    # ------------------------------------------------------------------
    def _element_kernels(self, u_T, fields, params, geoms=None,
                         physics=None):
        """Per block (Fe, Ke, diag_e) of the dense WeakForm `physics`
        (default self.physics) at the channel-first u_T (V, N) (the
        reference's _element_kernels, rdcfes_tpu/systems/
        transient.py:452-470)."""
        physics = physics or self.physics
        if physics is None:
            raise ValueError("the dense path needs physics= (a WeakForm "
                             "callable); the block form's qp path needs "
                             "plain-scalar params")
        geoms = self.geoms if geoms is None else geoms
        out = []
        for bi, (blk, g) in enumerate(zip(self.blocks, geoms)):
            u_qp, grad_qp = blk.interp(self.ops, u_T, g)
            wf = physics(u_qp, grad_qp, self._fields_for_block(bi, fields),
                         params)
            out.append(blk.element_kernels(wf, g))
        return out

    def _dense_matvec(self, x, KeBs):
        """The dense operator: each block's batched element apply, then
        K4 (the reference's _elem_matvec)."""
        return self._restrict([blk.dense_apply(KB, x)
                               for blk, KB in zip(self.blocks, KeBs)],
                              self.n_vars)

    def _dense_body(self, state, fields, params, Dinv, geoms=None):
        """One dense step (the reference's _step_impl, _step_reuse_impl and
        _step_moving_impl with _solve_clamped and _solve_mixed).  Dinv
        None = build a fresh block-Jacobi inverse.  Returns (new_state,
        inner iterations, residual, Dinv)."""
        V, N = self.n_vars, self.mesh.n_nodes
        kern = self._element_kernels(state["u"].T.contiguous(), fields,
                                     params, geoms)
        b = self._restrict([Fe for Fe, _, _ in kern], V)
        if Dinv is None:
            D = self._restrict([d for _, _, d in kern],
                               V * V).reshape(V, V, N)
            Dinv = small_block_inverse(D, pivot=False)
        KeBs = [ElementBlock.batched(Ke) for _, Ke, _ in kern]
        del kern
        pre_matvec = lambda x: apply_block_jacobi(
            Dinv, self._dense_matvec(x, KeBs))
        pre_b = apply_block_jacobi(Dinv, b)
        x0 = (2.0 * state["u"] - state["u_old"]).T.contiguous()
        if self._refines():
            f32 = torch.float32
            KeB32 = [KB.to(f32) for KB in KeBs]
            Dinv32 = Dinv.to(f32)
            mv32 = lambda x: apply_block_jacobi(
                Dinv32, self._dense_matvec(x, KeB32))
            u_raw, iters, resid = refine_mixed(mv32, pre_matvec, pre_b, x0,
                                               self.rtol, self.maxiter,
                                               **self._refine_kw)
        else:
            r = _METHODS[self.method](pre_matvec, pre_b, x0=x0,
                                      rtol=self.rtol, maxiter=self.maxiter)
            u_raw, iters, resid = r.x, r.iters, r.residual
        u_new = self.clamp(u_raw)
        new_state = {"u": u_new.T, "u_old": state["u"],
                     "u_older": state["u_old"], "u_raw": u_raw.T}
        return new_state, iters, resid, Dinv

    def _assembly_tables(self):
        """The node-pair sparsity and the K4 table (C, nnz) int32 that
        gathers the blocks' concatenated flat Ke buffers onto its slots,
        made at the first `assemble`."""
        if self._slot_gather is None:
            N = self.mesh.n_nodes
            if self.mesh.elem_type == "MIXED":
                self.sp, slot_lists = build_sparsity_mixed(self.mesh.blocks,
                                                           N)
            else:
                self.sp = build_sparsity(self.mesh.connectivity, N)
                slot_lists = [self.sp.slots_flat_cf()]
            self._slot_gather = torch.as_tensor(
                invert_scatter(np.concatenate(slot_lists), self.sp.nnz),
                device=self.device)
        return self.sp, self._slot_gather

    def assemble(self, u_T, fields: Optional[Dict] = None,
                 params: Optional[Dict] = None, geom=None):
        """(values (V, V, nnz), rhs (V, N)) of one linearized-CN step from
        the channel-first u_T (V, N): the dense WeakForm's element
        matrices gathered onto the slots of the node-pair sparsity
        `self.sp` (pairs sorted by (row, col)) and its element vectors
        onto the nodes, both by K4 (the reference's assemble,
        rdcfes_tpu/systems/transient.py:435-450).  The WeakForm is
        `physics`, or the block form's to_dense() on a system without one.
        geom: the blocks' Geometry records (default the rest geometry)."""
        V = self.n_vars
        _, slot_gather = self._assembly_tables()
        u_T = torch.as_tensor(u_T, dtype=self.dtype, device=self.device)
        physics = self.physics or (lambda *a: self.physics_blocks(*a)
                                   .to_dense())
        kern = self._element_kernels(u_T.contiguous(), fields or {},
                                     params or {}, geom, physics)
        values = self._restrict([Ke for _, Ke, _ in kern], V * V,
                                slot_gather).reshape(V, V, -1)
        b = self._restrict([Fe for Fe, _, _ in kern], V)
        return values, b

    @staticmethod
    def _plain_params(params) -> Optional[Dict[str, float]]:
        """params as floats when every one is a plain number (what the qp
        path takes), else None."""
        if not params or not all(isinstance(v, (int, float))
                                 for v in params.values()):
            return None
        return {k: float(v) for k, v in params.items()}

    # ------------------------------------------------------------------
    def step(self, state: Dict, fields: Optional[Dict] = None,
             params: Optional[Dict] = None, coords=None,
             scalars: Optional[Dict] = None):
        """Advance one time step.  Returns (new_state, lin_iters,
        lin_residual).  The qp path when the system has physics_blocks and
        every param is a plain number, else the dense path (the
        reference's dispatch).  The block-Jacobi inverse is rebuilt on the
        first call and then every `precond_refresh` calls; on a moving
        mesh, on every call, with the geometry at `coords` (the
        reference's _step_moving, served on the qp path with the same
        operator when there is a block form)."""
        geoms = self._moving_geoms(coords)
        fields = {**(fields or {}), **(scalars or {})}
        p = self._plain_params(params)
        if self.physics_blocks is not None and p is not None:
            body = self._step_body
        else:
            body, p = self._dense_body, dict(params or {})
        if geoms is not None:
            self._dinv_cache = None  # it belongs to another geometry
            return body(state, fields, p, None, geoms)[:3]
        if (self.precond_refresh > 1 and self._dinv_cache is not None
                and self._steps_since_precond < self.precond_refresh):
            self._steps_since_precond += 1
            new_state, iters, res, _ = body(state, fields, p,
                                            self._dinv_cache)
            return new_state, iters, res
        new_state, iters, res, Dinv = body(state, fields, p, None)
        self._dinv_cache = Dinv
        self._steps_since_precond = 1
        return new_state, iters, res

    def choose_subcycle(self, state: Dict, fields: Optional[Dict] = None,
                        params: Optional[Dict] = None,
                        scalars: Optional[Dict] = None, coords=None,
                        scalar_traj: Optional[Dict] = None, kmax: int = 32,
                        stall_factor: float = 100.0, k0: int = 1) -> int:
        """Adaptive subcycle factor: probe ONE step at dt/k0, dt/2k0, ...
        from `state` (the probes' results are discarded) and return the
        first k whose linear solve converges (residual <= stall_factor *
        rtol), or the first k >= kmax.  A set-up call: run it once per
        (mesh, params) regime, outside any timed loop, and pass the result
        as run_steps(subcycle=k), or let run_steps(subcycle="auto") call
        it.  `k0` starts the ladder above 1 when lower k are known to
        fail.  The probe sees the first-step values of `scalar_traj`."""
        f = dict(fields or {})
        if scalar_traj:
            f.update({k: float(np.asarray(v)[0])
                      for k, v in scalar_traj.items()})
        k = max(1, int(k0))
        while True:
            p = dict(params)
            p["dt"] = float(params["dt"]) / k
            _, _, res = self.step(state, fields=f, params=p, coords=coords,
                                  scalars=scalars)
            if float(res) <= stall_factor * self.rtol or k >= kmax:
                return k
            k *= 2

    def run_steps(self, state: Dict, n: int, fields: Optional[Dict] = None,
                  params: Optional[Dict] = None,
                  scalars: Optional[Dict] = None, coords=None,
                  subcycle=None, scalar_traj: Optional[Dict] = None,
                  field_update: Optional[Callable] = None, field_aux=None,
                  field_args=()):
        """Advance n steps.  Returns (state, iters_per_step (n,) int64 on
        the CPU, residual_per_step (n,) on the state's device), plus the
        final `field_update` carry when `field_update` is given.  Step i
        rebuilds the block-Jacobi inverse when i % precond_refresh == 0,
        i counted over the whole call: the reference's
        run_steps(n, segment=n).  The reference chains scans of at most
        `segment` steps (default 50) and restarts the count in each, so
        the two schedules differ when n > segment and precond_refresh
        does not divide segment; the port keeps one schedule and has no
        segments.

        `subcycle=k` (int > 1) advances each requested step as k substeps
        at dt/k; `subcycle="auto"` probes for the smallest power-of-two k
        whose linear solve converges (choose_subcycle).  It is the answer
        to advection-dominated regimes (taxis CFL of a few and more) where
        the linearized-CN operator of the full dt turns indefinite and no
        Krylov/preconditioner pair converges.  Iterations and residuals
        come back per OUTER step (iterations summed, the residual of the
        last substep); `scalar_traj` values are held over an outer step's
        substeps; the returned history (u_old, u_older, u_raw) is at
        SUBSTEP spacing.

        `scalar_traj` maps a scalar-field name to its per-step values,
        shape (n,): step j sees value [j] as a Python float (ADPM's
        advancing `time`); `scalars` entries are constant over all steps.

        `field_update(state, aux, tr, *field_args) -> (fields, new_aux)`
        runs BEFORE each step, for fields derived from the carried
        solution (RIPF's time-derivative fields); `tr` holds that step's
        scalar_traj values, `field_aux` is the first carry.

        On a moving mesh the geometry is built once, from `coords`, for
        all n steps (the coupled driver moves the mesh only between
        calls), and the block-Jacobi inverse cached by `step` is dropped
        (the reference's run_steps(coords=), rdcfes_tpu/systems/
        transient.py:1124-1130)."""
        if self.physics_blocks is None:
            raise ValueError("run_steps needs physics_blocks (the qp "
                             "path), as the reference's does")
        n = int(n)
        if subcycle not in (None, 1):
            k = (self.choose_subcycle(state, fields=fields, params=params,
                                      scalars=scalars, coords=coords,
                                      scalar_traj=scalar_traj)
                 if subcycle == "auto" else int(subcycle))
            if k > 1:
                p_sub = dict(params)
                p_sub["dt"] = float(params["dt"]) / k
                traj_sub = {kk: np.repeat(np.asarray(v), k)
                            for kk, v in (scalar_traj or {}).items()}
                out = self.run_steps(
                    state, n * k, fields=fields, params=p_sub,
                    scalars=scalars, scalar_traj=traj_sub or None,
                    field_update=field_update, field_aux=field_aux,
                    field_args=field_args, coords=coords)
                its = out[1].reshape(n, k).sum(dim=1)
                ress = out[2].reshape(n, k)[:, -1]
                return (out[0], its, ress) + out[3:]
        fields = {**(fields or {}), **(scalars or {})}
        traj = {k: np.asarray(v, dtype=np.float64)
                for k, v in (scalar_traj or {}).items()}
        for k, v in traj.items():
            if v.shape != (n,):
                raise ValueError(f"scalar_traj[{k!r}] must have shape "
                                 f"({n},), got {v.shape}")
        p = self._plain_params(params)
        if p is None:
            raise ValueError("the qp path needs plain-scalar params")
        geoms = self._moving_geoms(coords)
        if geoms is not None:
            self._dinv_cache = None
        refresh = max(1, self.precond_refresh)
        Dinv = None
        aux = field_aux
        its, ress = [], []
        for i in range(n):
            tr = {k: float(v[i]) for k, v in traj.items()}
            f = {**fields, **tr}
            if field_update is not None:
                fu, aux = field_update(state, aux, tr, *field_args)
                f = {**f, **fu}
            state, it, res, Dinv = self._step_body(
                state, f, p, None if i % refresh == 0 else Dinv, geoms)
            its.append(it)
            ress.append(res)
        ress = (torch.stack(ress) if ress
                else torch.empty(0, dtype=self.dtype, device=self.device))
        out = (state, torch.tensor(its, dtype=torch.int64), ress)
        return out + ((aux,) if field_update is not None else ())
