"""Transient RDC system on a mixed-element-type mesh (port of
rdcfes_tpu.systems.mixed).

A MixedMesh is per-type blocks over one node set, and the global operator
is the sum of the block restrictions,

    A = sum_b  P_b^T A_b P_b .

The numerics are the reference's: one linearized Crank-Nicolson step per
time step, the block-Jacobi diagonal summed over the blocks, a
left-preconditioned solve (precision "mixed": refine_mixed with
inner_rtol 1e-7 and a fixed inner tolerance, rdcfes_tpu/systems/
mixed.py:283-285; "f64": BiCGStab or GMRES), the clamp at zero with the
u_raw history, and the stale block-Jacobi inverse reused for
`precond_refresh` calls of `step` (run_steps is TransientRDCSystem's).

Inside, each block runs the port's own qp path (ElementBlock), as a
single-type TransientRDCSystem does: the TET4 block K1, K2 and K3, the
HEX8, PRISM6 and PYRAMID5 blocks K8 and K6, and one K4 launch restricts
the blocks' corner values, concatenated in block order, through one table
built from their connectivities.  The reference materialises per-block
element matrices instead; both compute the same operator.

Elemental fields (ADPM's tracts) arrive over the block-concatenated
element order and are sliced per block; a tuple or list field holds one
entry per block (PROTEAS's dose and RIPF's rebuilt fields at each
block's quadrature points).

With `constraints=` (the rows [h, a, b] of mesh/adapt_ext.
MixedConstrained: the TET4 block refined 1:8 against the blocks that do
not refine) the solve runs on C^T A C as on a single-type mesh: the same
`Constraints` object of systems/transient.py around the blocks' element
applies and their one K4 restriction (the reference's _c_apply and
_ct_fold, rdcfes_tpu/systems/mixed.py:123-137, :210-221; the fold an
ordered gather-sum, no atomics).

With `moving_mesh=True` (the coupled HCC driver's deformed positions)
every block's geometry is rebuilt from the `coords` that `step` and
`run_steps` are given, once per call, and the block-Jacobi inverse with
it (the reference's _step_moving_impl, rdcfes_tpu/systems/mixed.py:
311-325); the kernels then run on those geometries.

A dense `physics=` WeakForm runs TransientRDCSystem's dense path over the
blocks (one Ke per block, their applies restricted by the one K4 table),
the reference's own path on a MixedMesh; `assemble_scipy` gives the
global operator and right-hand side as scipy objects, the reference's
oracle surface (rdcfes_tpu/systems/mixed.py:364-398).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..fem.constraints import Constraints
from ..fem.kernels import KERNEL_OPS, Ops
from ..solvers.krylov import DEFAULT_MAXITER, DEFAULT_RTOL
from .transient import TransientRDCSystem, clamp_nonnegative


class MixedTransientRDCSystem(TransientRDCSystem):
    """TransientRDCSystem's surface on a MixedMesh: initial_state,
    gather_state, scatter_state, step and run_steps with the same state
    dict (u, u_old, u_older, u_raw) and the same (state, iters, residual)
    results.  The arguments are TransientRDCSystem's, dtype too (the
    reference's rules, rdcfes_tpu/systems/mixed.py:71-84: f32 floors the
    rtol at 1e-6 and never refines against f64)."""

    # mixed-mesh transition elements amplify the residual into the
    # solution error by ~1e5, so each refinement pass runs to 1e-7
    # (the reference's settings)
    _refine_kw = {"inner_rtol": 1e-7, "adaptive_tol": False}

    def __init__(self, mesh, n_vars: int,
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
        if mesh.elem_type != "MIXED":
            raise ValueError(f"MixedTransientRDCSystem takes a MixedMesh, "
                             f"got {mesh.elem_type}")
        self._setup(mesh, [(b.elem_type, b.connectivity)
                           for b in mesh.blocks], n_vars, physics_blocks,
                    clamp, rtol, maxiter, precision, precond_refresh,
                    device, ops, method, physics, dtype)
        self.moving_mesh = bool(moving_mesh)
        if constraints is not None and len(constraints):
            self.cons = Constraints(constraints, self.device)
        # each block's [start, start + n) in the concatenated element order
        starts = np.cumsum([0] + [b.n_elems for b in mesh.blocks])
        self._block_off = [(int(a), int(b - a))
                           for a, b in zip(starts[:-1], starts[1:])]

    def _fields_for_block(self, bi: int, fields: Dict) -> Dict:
        """Block bi's fields (the reference's rules, rdcfes_tpu/systems/
        mixed.py:152-168): an elemental field (leading axis n_elems) is
        sliced to the block's range, a tuple or list selects entry bi, and
        anything else (nodal fields, scalars) passes through."""
        off, nb = self._block_off[bi]
        out = {}
        for k, v in fields.items():
            if isinstance(v, (tuple, list)):
                out[k] = v[bi]
            elif (getattr(v, "ndim", 0) >= 1
                  and v.shape[0] == self.mesh.n_elems):
                out[k] = v[off:off + nb]
            else:
                out[k] = v
        return out

    def assemble_scipy(self, u_T, fields: Optional[Dict] = None,
                       params: Optional[Dict] = None):
        """(A, b): the global block-CSR operator as a scipy CSR matrix
        (V N, V N), species-major, and the right-hand side (V N,), on the
        host: `assemble`'s values on the node-pair sparsity of the blocks
        (the reference's assemble_scipy, rdcfes_tpu/systems/
        mixed.py:364-398, which sums per-block scipy matrices)."""
        import scipy.sparse as sps

        values, b = self.assemble(u_T, fields, params)
        values = values.cpu().numpy().astype(np.float64)
        V, N, sp = self.n_vars, self.mesh.n_nodes, self.sp
        A = sps.bmat([[sps.csr_matrix((values[v, w], (sp.rows, sp.cols)),
                                      shape=(N, N)) for w in range(V)]
                      for v in range(V)], format="csr")
        return A, b.cpu().numpy().astype(np.float64).reshape(V * N)
