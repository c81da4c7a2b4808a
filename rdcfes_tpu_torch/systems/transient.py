"""Transient linearized-Crank-Nicolson RDC system, matrix-free qp path
(port of rdcfes_tpu.systems.transient for affine TET4 meshes).

Per time step, as in the reference app's TransientLinearImplicitSystem
use (src/pihna.C:66-93):
  1. rotate history (older <- old <- current);
  2. gather u to element corners and interpolate to quadrature points
     (K1), evaluate the coefficient blocks, build the element right-hand
     side (K2) and restrict it to the nodal b (K4);
  3. every `precond_refresh` steps, restrict the per-element (i, i)
     blocks to the block-Jacobi diagonal (K4) and invert it;
  4. solve with mixed-precision iterative refinement: f32 BiCGStab passes
     with f64 residual correction and an f64 rescue; every matvec is K3
     (gather + affine element apply) followed by K4;
  5. clamp at zero (`check_solution`, src/pihna.C:760-803).

Layouts are channel-first inside (u is (V, N)); the public state keeps the
reference's (N, V) arrays.  PyTorch runs eagerly, so the step is plain
Python: the reference's jit/scan machinery has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..fem.assembly import build_sparsity, gather_tables
from ..fem.geometry import geometry_factors
from ..fem.kernels import KERNEL_OPS, Ops, stack_apply, stack_rhs
from ..fem.weakform import block_diag_affine, diffusion_presum
from ..mesh.core import Mesh
from ..solvers.krylov import (DEFAULT_MAXITER, DEFAULT_RTOL, _dot,
                              apply_block_jacobi, bicgstab,
                              small_block_inverse)
from ..utils.convert import state_from_numpy, state_to_numpy
from ..utils.device import cuda_device

# where the unported options land (ROADMAP.md, queue 1)
_GENERIC = ("ROADMAP queue 1 item 8 (generic path, rest of the transient "
            "system)")
_MOVING = "ROADMAP queue 1 item 12 (coupled HCC, moving mesh)"
_AMR = "ROADMAP queue 1 item 13 (mixed meshes and AMR)"


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
    """A transient multi-species RDC system on a fixed TET4 mesh, stepped
    on the matrix-free qp path in mixed precision.

    mesh            : host Mesh (TET4)
    n_vars          : number of coupled nodal variables V
    physics_blocks  : callable(u_qp (V,Q,E), grad_qp (V,Q,3,E), fields,
                      params) -> WeakFormBlocks (e.g. models.pihna)
    clamp           : callable(u (V,N)) -> (V,N), applied after each solve
    rtol, maxiter   : linear tolerance on the preconditioned residual, and
                      the f64 rescue's iteration cap
    precision       : "mixed" (the only precision of this slice)
    precond_refresh : recompute the block-Jacobi inverse every k steps
    device          : where the tables and the state live; None (the
                      default) is the CUDA card (utils.device.cuda_device,
                      which raises without one: never the CPU)
    ops             : fem.kernels.KERNEL_OPS (default) or PLAIN_OPS, the
                      plain torch versions of the same four operations
    """

    def __init__(self, mesh: Mesh, n_vars: int, physics_blocks: Callable,
                 clamp: Callable = clamp_nonnegative,
                 rtol: float = DEFAULT_RTOL,
                 maxiter: int = DEFAULT_MAXITER, precision: str = "mixed",
                 precond_refresh: int = 1,
                 constraints: Optional[np.ndarray] = None,
                 moving_mesh: bool = False, device=None,
                 ops: Ops = KERNEL_OPS):
        if mesh.elem_type != "TET4":
            raise NotImplementedError(
                f"{mesh.elem_type} meshes (non-affine qp path): {_GENERIC}")
        if constraints is not None and len(constraints):
            raise NotImplementedError(f"hanging-node constraints: {_AMR}")
        if moving_mesh:
            raise NotImplementedError(f"moving mesh: {_MOVING}")
        if precision != "mixed":
            raise NotImplementedError(f"precision={precision!r}: {_GENERIC}")
        self.mesh = mesh
        self.n_vars = n_vars
        self.physics_blocks = physics_blocks
        self.clamp = clamp
        self.rtol = rtol
        self.maxiter = maxiter
        self.precision = precision
        self.precond_refresh = int(precond_refresh)
        self.device = cuda_device() if device is None else torch.device(device)
        self.ops = ops
        self._dinv_cache = None
        self._steps_since_precond = 0

        conn = mesh.connectivity
        self.sp = build_sparsity(conn, mesh.n_nodes)
        _, node_gather = gather_tables(self.sp, conn)
        dev = self.device
        self.conn_T = torch.as_tensor(np.ascontiguousarray(conn.T),
                                      device=dev)
        self.node_gather = torch.as_tensor(node_gather, device=dev)
        coords = torch.as_tensor(mesh.coords, dtype=torch.float64, device=dev)
        self.phi, self.JxW, self.dphi = geometry_factors(
            coords, torch.as_tensor(conn, device=dev), mesh.elem_type)
        self.dphi0 = self.dphi[0]  # (K, 3, E): q-invariant on TET4
        # f32 geometry of the inner matvec
        self.JxW32 = self.JxW.to(torch.float32)
        self.dphi0_32 = self.dphi0.to(torch.float32)

    # ------------------------------------------------------------------
    def initial_state(self, u0) -> Dict[str, torch.Tensor]:
        u0 = torch.as_tensor(u0, dtype=torch.float64, device=self.device)
        if tuple(u0.shape) != (self.mesh.n_nodes, self.n_vars):
            raise ValueError(f"u0 shape {tuple(u0.shape)}, expected "
                             f"{(self.mesh.n_nodes, self.n_vars)}")
        # u_raw = the pre-clamp solver output (RIPF's bookkeeping uses it)
        return {"u": u0, "u_old": u0, "u_older": u0, "u_raw": u0}

    def gather_state(self, state: Dict) -> Dict[str, np.ndarray]:
        return state_to_numpy(state)

    def scatter_state(self, gstate: Dict) -> Dict[str, torch.Tensor]:
        return state_from_numpy(gstate, self.device)

    # ------------------------------------------------------------------
    def _matvec(self, x, stacks, JxW, dphi0):
        """Matrix-free operator: K3 (gather + element apply) then K4."""
        Ye = self.ops.apply_affine(x, self.conn_T, self.phi, JxW, dphi0,
                                   stacks)
        return self.ops.restrict(Ye.reshape(self.n_vars, -1),
                                 self.node_gather)

    def _step_body(self, state, fields, params, Dinv):
        """One qp step (the reference's _qp_raw_body step_fn on the
        affine path).  Dinv None = build a fresh block-Jacobi inverse.
        Returns (new_state, inner iterations, residual, Dinv)."""
        V, N = self.n_vars, self.mesh.n_nodes
        ops = self.ops
        u_T = state["u"].T.contiguous()
        u_qp, gx1 = ops.gather_interp_affine(u_T, self.conn_T, self.phi,
                                             self.dphi0)
        # TET4: one gradient per element, broadcast over q for the physics
        grad_qp = gx1[:, None].expand(V, u_qp.shape[1], 3, gx1.shape[-1])
        wfb = self.physics_blocks(u_qp, grad_qp, fields, params)
        Fe = ops.rhs_affine(stack_rhs(wfb), self.JxW, self.phi, self.dphi0)
        b = ops.restrict(Fe.reshape(V, -1), self.node_gather)
        if Dinv is None:
            diag_e = block_diag_affine(wfb, self.phi, self.JxW, self.dphi)
            D = ops.restrict(diag_e.reshape(V * V, -1), self.node_gather)
            Dinv = small_block_inverse(D.reshape(V, V, N), pivot=False)
        # once-per-step diffusion q-sum, reused by every matvec
        st64 = stack_apply(wfb, diffusion_presum(wfb, self.JxW))
        pre_matvec = lambda x: apply_block_jacobi(
            Dinv, self._matvec(x, st64, self.JxW, self.dphi0))
        pre_b = apply_block_jacobi(Dinv, b)
        # linear extrapolation warm start
        x0 = (2.0 * state["u"] - state["u_old"]).T.contiguous()
        # the f32 operator is built from f32 casts of the f64 blocks, its
        # diffusion q-sum taken in f32 (as the reference's wfb.cast path)
        wfb32 = wfb.cast(torch.float32)
        st32 = stack_apply(wfb32, diffusion_presum(wfb32, self.JxW32))
        Dinv32 = Dinv.to(torch.float32)
        mv32 = lambda x: apply_block_jacobi(
            Dinv32, self._matvec(x, st32, self.JxW32, self.dphi0_32))
        u_raw, iters, resid = refine_mixed(mv32, pre_matvec, pre_b, x0,
                                           self.rtol, self.maxiter)
        u_new = self.clamp(u_raw)
        new_state = {"u": u_new.T, "u_old": state["u"],
                     "u_older": state["u_old"], "u_raw": u_raw.T}
        return new_state, iters, resid, Dinv

    @staticmethod
    def _plain_params(params) -> Dict[str, float]:
        if not params or not all(isinstance(v, (int, float))
                                 for v in params.values()):
            raise ValueError("the qp path needs plain-scalar params")
        return {k: float(v) for k, v in params.items()}

    # ------------------------------------------------------------------
    def step(self, state: Dict, fields: Optional[Dict] = None,
             params: Optional[Dict] = None, coords=None,
             scalars: Optional[Dict] = None):
        """Advance one time step.  Returns (new_state, lin_iters,
        lin_residual).  The block-Jacobi inverse is rebuilt on the first
        call and then every `precond_refresh` calls."""
        if coords is not None:
            raise NotImplementedError(f"moving mesh: {_MOVING}")
        fields = {**(fields or {}), **(scalars or {})}
        p = self._plain_params(params)
        if (self.precond_refresh > 1 and self._dinv_cache is not None
                and self._steps_since_precond < self.precond_refresh):
            self._steps_since_precond += 1
            new_state, iters, res, _ = self._step_body(state, fields, p,
                                                       self._dinv_cache)
            return new_state, iters, res
        new_state, iters, res, Dinv = self._step_body(state, fields, p, None)
        self._dinv_cache = Dinv
        self._steps_since_precond = 1
        return new_state, iters, res

    def run_steps(self, state: Dict, n: int, fields: Optional[Dict] = None,
                  params: Optional[Dict] = None,
                  scalars: Optional[Dict] = None, coords=None,
                  subcycle=None):
        """Advance n steps.  Returns (state, iters_per_step (n,) int64 on
        the CPU, residual_per_step (n,) on the state's device).  Step i
        rebuilds the block-Jacobi inverse when i % precond_refresh == 0,
        as the reference's scan does."""
        if subcycle not in (None, 1):
            raise NotImplementedError(f"subcycling: {_GENERIC}")
        if coords is not None:
            raise NotImplementedError(f"moving mesh: {_MOVING}")
        fields = {**(fields or {}), **(scalars or {})}
        p = self._plain_params(params)
        refresh = max(1, self.precond_refresh)
        Dinv = None
        its, ress = [], []
        for i in range(int(n)):
            state, it, res, Dinv = self._step_body(
                state, fields, p, None if i % refresh == 0 else Dinv)
            its.append(it)
            ress.append(res)
        ress = (torch.stack(ress) if ress
                else torch.empty(0, dtype=torch.float64, device=self.device))
        return state, torch.tensor(its, dtype=torch.int64), ress
