"""Newton solver of the nonlinear solid path (torch port of
rdcfes_tpu.solvers.newton).

Replaces libMesh's NewtonSolver/DiffSolver as the reference app configures
it (src/solid_system.C:86-100): the stopping rules and knobs mirror the
deck's `solver/nonlinear/*` and `solver/linear/*` parameters.

The Newton loop runs on the host, as in the reference: it reads the
residual norm, the linear residual and a finiteness flag back after every
stage.  Each linear stage re-lays the assembled block values into ELLPACK
once and runs a left block-Jacobi-preconditioned BiCGStab on the ELL SpMV
(kernel K5 through `ops.ell_matvec`): in f64, or ("mixed") as f32 sweeps
with an f64 residual carry and f64 rescue (systems.transient.refine_mixed);
`linear_method="gmres"` runs restarted GMRES in f64 on the same
preconditioned operator instead.

With `constraints=` (rows [h, a, b]: x_h = (x_a + x_b) / 2, the hanging
nodes of a remeshed MIXED mesh) Newton iterates in the reduced space, as
the reference's does (rdcfes_tpu/solvers/newton.py:93-107, :175-236):
every matvec of every branch (f64 BiCGStab and GMRES, the mixed f32
sweeps and the f64 rescue) is C^T K C, `ct_fold(K5(c_apply(y)))`; the
right-hand side is folded; the block-Jacobi inverse is the unconstrained
one, whose node blocks keep the hanging rows' zeros; the update is
expanded with `c_apply`, so a constrained x0 stays constrained; and the
stopping rules read ||C^T R||.  The constraint algebra is
fem/constraints.Constraints (ordered gather-sums, no atomics).

Not ported: the TPU's Beneš-routed SpMV (`fast_gather`,
RDCFES_SOLID_FAST), which has no counterpart on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..fem.assembly import NodePairSparsity, ell_structure
from ..fem.bcsr import to_ell
from ..fem.constraints import Constraints
from ..fem.kernels import KERNEL_OPS, Ops
from ..utils.device import cuda_device
from .krylov import (apply_block_jacobi, bicgstab, block_jacobi_inverse,
                     gmres)

_LINEAR = {"bicgstab": bicgstab, "gmres": gmres}


class NewtonOptions(NamedTuple):
    max_nonlinear_iterations: int = 100
    relative_step_tolerance: float = 1e-3
    relative_residual_tolerance: float = 1e-8
    absolute_residual_tolerance: float = 1e-8
    require_residual_reduction: bool = False
    max_linear_iterations: int = 50000
    initial_linear_tolerance: float = 1e-3
    linear_method: str = "bicgstab"
    # "f64": plain double Krylov, as the reference's PETSc KSP; "mixed":
    # f32 inner BiCGStab sweeps + f64 outer residual carry and rescue
    linear_precision: str = "f64"
    # bisect the step at most this many times when residual reduction is
    # required (libMesh NewtonSolver line-search role)
    max_line_search_steps: int = 8
    # modified Newton: keep the assembled tangent while the residual
    # contracts by at least tangent_refresh_ratio per accepted step;
    # reassemble at the current iterate as soon as contraction degrades,
    # and before declaring a failure
    reuse_tangent: bool = False
    tangent_refresh_ratio: float = 0.3


class NewtonResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual_norm: float
    initial_residual_norm: float
    # True when a stopping rule was met; False on divergence (failed line
    # search, linear breakdown, iteration cap)
    converged: bool = True
    # inner Krylov iterations summed over every linear stage
    linear_iters: int = 0


class NewtonSolver:
    """Reusable Newton solver over one node-pair sparsity.

    sp          : fem.assembly.NodePairSparsity of the operator
    opts        : NewtonOptions
    constraints : (H, 3) hanging-node rows [h, a, b], or None
    device      : where the ELL tables live (the assembled values'
                  device); None is the CUDA card, and raises without one
    ops         : fem.kernels.KERNEL_OPS or PLAIN_OPS (for ell_matvec)
    """

    def __init__(self, sp: NodePairSparsity,
                 opts: NewtonOptions = NewtonOptions(),
                 constraints: Optional[np.ndarray] = None, device=None,
                 ops: Ops = KERNEL_OPS):
        if opts.linear_method not in _LINEAR:
            raise ValueError(f"unknown linear_method {opts.linear_method!r}")
        if opts.linear_precision not in ("f64", "mixed"):
            raise ValueError(
                f"unknown linear_precision {opts.linear_precision!r}")
        self.sp = sp
        self.opts = opts
        self.ops = ops
        dev = cuda_device() if device is None else torch.device(device)
        ell_cols, ell_slot = ell_structure(sp)
        self._ell_cols = torch.as_tensor(ell_cols, device=dev)
        self._ell_slot = torch.as_tensor(ell_slot, device=dev)
        self._diag_slots = torch.as_tensor(sp.diag_slots, device=dev)
        self.cons = (Constraints(constraints, dev)
                     if constraints is not None and len(constraints)
                     else None)

    def _operator(self, values_ell: torch.Tensor):
        """y -> K y through K5, or C^T K C y with constraints."""
        ops, cols, cons = self.ops, self._ell_cols, self.cons
        if cons is None:
            return lambda y: ops.ell_matvec(values_ell, cols, y)
        return lambda y: cons.ct_fold(
            ops.ell_matvec(values_ell, cols, cons.c_apply(y)))

    def _linear_solve(self, values: torch.Tensor, rhs: torch.Tensor,
                      rtol: float):
        """Solve K dx = rhs with K's block values (V, V, nnz); returns
        (dx, inner iterations, final preconditioned |r| / |b|)."""
        opts = self.opts
        f32, f64 = torch.float32, torch.float64
        values_ell = to_ell(values, self._ell_slot)
        K64 = self._operator(values_ell.to(f64))
        # the unconstrained diagonal blocks, as the reference's: node
        # blocks keep the hanging rows of C^T K C y zero
        Dinv = block_jacobi_inverse(values, self._diag_slots)
        if self.cons is not None:
            rhs = self.cons.ct_fold(rhs)
        # LEFT preconditioning, the preconditioned residual as the
        # convergence measure (PETSc's default): penalty rows dwarf the
        # material rows, so a raw-residual criterion stalls
        pre_matvec = lambda y: apply_block_jacobi(Dinv, K64(y))
        pre_b = apply_block_jacobi(Dinv, rhs)
        if (opts.linear_precision == "mixed"
                and opts.linear_method == "bicgstab"):
            # imported here: systems/ imports this module
            from ..systems.transient import refine_mixed

            K32, Dinv32 = self._operator(values_ell.to(f32)), Dinv.to(f32)
            mv32 = lambda y: apply_block_jacobi(Dinv32, K32(y))
            return refine_mixed(mv32, pre_matvec, pre_b,
                                torch.zeros_like(pre_b), rtol,
                                opts.max_linear_iterations)
        res = _LINEAR[opts.linear_method](
            pre_matvec, pre_b, rtol=rtol, maxiter=opts.max_linear_iterations)
        return res.x, res.iters, res.residual

    def _res_norm(self, R: torch.Tensor) -> float:
        """||R||, or the reduced-space ||C^T R|| with constraints (the
        hanging rows' forces belong to their masters)."""
        if self.cons is not None:
            R = self.cons.ct_fold(R)
        return float(torch.linalg.vector_norm(R))

    def solve(self, assemble: Callable[[torch.Tensor],
                                       Tuple[torch.Tensor, torch.Tensor]],
              x0: torch.Tensor,
              residual_only: Optional[Callable] = None) -> NewtonResult:
        """Solve R(x) = 0 given `assemble(x) -> (R (V, N), values (V, V,
        nnz))` on channel-first x (V, N).

        `residual_only(x) -> R`, when given, serves the line-search trials
        and the modified-Newton residual checks, so the tangent assembly
        runs only when the tangent is (re)built."""
        opts = self.opts
        x = x0
        R, values = assemble(x)
        rnorm = self._res_norm(R)
        r0 = rnorm if rnorm > 0 else 1.0
        k = 0
        lin_total = 0
        converged = False
        # modified-Newton state: True while `values` was assembled at an
        # earlier iterate (opts.reuse_tangent); a failure with a stale
        # tangent refreshes it at the current x and retries
        stale = False

        def refresh():
            nonlocal R, values, rnorm, stale
            R, values = assemble(x)
            rnorm = self._res_norm(R)
            stale = False

        trial_R = residual_only if residual_only is not None else (
            lambda y: assemble(y)[0])
        while k < opts.max_nonlinear_iterations:
            if rnorm <= opts.absolute_residual_tolerance:
                converged = True
                break
            if rnorm / r0 <= opts.relative_residual_tolerance:
                converged = True
                break
            # the inner tolerance follows the nonlinear residual reduction
            lin_rtol = max(min(opts.initial_linear_tolerance, rnorm / r0),
                           1e-14)
            dx, lin_iters, lin_res = self._linear_solve(values, -R, lin_rtol)
            lin_total += int(lin_iters)
            if self.cons is not None:
                # dx_h = (dx_a + dx_b) / 2: x stays constrained
                dx = self.cons.c_apply(dx)

            lam = 1.0
            if not bool(torch.isfinite(dx).all()):
                if stale:
                    refresh()
                    continue
                break  # hard linear breakdown: keep the current iterate
            R_acc = None
            skip_step_check = False
            if float(lin_res) > 1.0 and not opts.require_residual_reduction:
                # the linear stage diverged: bisect for a residual
                # reduction before taking any of the step
                ok = False
                for _ in range(opts.max_line_search_steps):
                    R_new = trial_R(x + lam * dx)
                    if self._res_norm(R_new) < rnorm:
                        ok = True
                        break
                    lam *= 0.5
                if not ok:
                    if stale:
                        refresh()
                        continue
                    break
                R_acc = R_new
                # a diverged linear stage must not satisfy the step rule
                skip_step_check = True
            elif opts.require_residual_reduction:
                reduced = False
                for _ in range(opts.max_line_search_steps):
                    R_new = trial_R(x + lam * dx)
                    if self._res_norm(R_new) < rnorm:
                        reduced = True
                        break
                    lam *= 0.5
                if not reduced:
                    if stale:
                        refresh()
                        continue
                    break  # DIVERGED_BACKTRACKING_FAILURE
                R_acc = R_new

            x = x + lam * dx
            if opts.reuse_tangent:
                R_new = R_acc if R_acc is not None else trial_R(x)
                rnorm_new = self._res_norm(R_new)
                if rnorm_new > opts.tangent_refresh_ratio * rnorm:
                    refresh()  # contraction degraded: a fresh tangent
                else:
                    R = R_new
                    rnorm = rnorm_new
                    stale = True
            else:
                R, values = assemble(x)
                rnorm = self._res_norm(R)
            k += 1

            if skip_step_check:
                continue
            xnorm = float(torch.linalg.vector_norm(x))
            step_rel = lam * float(torch.linalg.vector_norm(dx)) / (
                xnorm if xnorm else 1.0)
            if step_rel <= opts.relative_step_tolerance:
                converged = True
                break
        else:
            # iteration cap: converged iff the final residual meets a rule
            converged = (rnorm <= opts.absolute_residual_tolerance
                         or rnorm / r0 <= opts.relative_residual_tolerance)
        return NewtonResult(x=x, iters=k, residual_norm=rnorm,
                            initial_residual_norm=r0, converged=converged,
                            linear_iters=lin_total)


def newton_solve(assemble, x0: torch.Tensor, sp: NodePairSparsity,
                 opts: NewtonOptions = NewtonOptions(), rows=None,
                 cols=None, diag_slots=None, device=None,
                 ops: Ops = KERNEL_OPS) -> NewtonResult:
    """One-shot convenience wrapper around NewtonSolver (the reference's
    newton_solve, whose rows / cols / diag_slots go unused, as here):
    NewtonSolver(sp, opts, device=device, ops=ops).solve(assemble, x0)."""
    return NewtonSolver(sp, opts, device=device, ops=ops).solve(assemble,
                                                                x0)
