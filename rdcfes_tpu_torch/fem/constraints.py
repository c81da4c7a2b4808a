"""Hanging-node constraints u_h = (u_a + u_b) / 2 on channel-first
tensors, shared by the transient systems (systems/transient.py,
systems/mixed.py) and the solid's Newton (solvers/newton.py).

The rows [h, a, b] come from mesh/constrain.ConstrainedMesh or
mesh/adapt_ext.MixedConstrained.  A constrained solve runs on C^T A C
inside full vectors, as the reference's does (rdcfes_tpu/systems/
transient.py:619-634, rdcfes_tpu/solvers/newton.py:93-107): `c_apply`
gives every hanging entry its masters' mean, `ct_fold` folds the hanging
rows onto their two masters and zeroes them.  Both are plain torch index
ops without atomics: `c_apply` an index_copy onto the hanging rows,
`fold` a gather-sum through the inverse table of the masters in a fixed
order, so a constrained solve is bit-equal from run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import invert_scatter
from .assembly import restrict as gather_sum


class Constraints:
    """Hanging-node constraints u_h = (u_a + u_b) / 2 on channel-first
    tensors (W, N): rows [h, a, b] (H, 3), every a and b a master dof."""

    def __init__(self, rows: np.ndarray, device):
        rows = np.asarray(rows, dtype=np.int64)
        H = len(rows)
        ends = np.concatenate([rows[:, 1], rows[:, 2]])  # (2H,)
        masters, inv = np.unique(ends, return_inverse=True)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                         device=device)
        self.hang = as_t(rows[:, 0])
        self.a = as_t(rows[:, 1])
        self.b = as_t(rows[:, 2])
        self.masters = as_t(masters)
        # column c of this table: the c-th of each master's hanging
        # contributions in [y_h of a's rows | y_h of b's rows], pad 2H
        self.fold_table = as_t(invert_scatter(inv, len(masters)))
        self.n_hanging = H

    def c_apply(self, x: torch.Tensor) -> torch.Tensor:
        """C: every hanging entry set to the mean of its masters."""
        return x.index_copy(1, self.hang,
                            0.5 * (x[:, self.a] + x[:, self.b]))

    def fold(self, y: torch.Tensor, weight: float) -> torch.Tensor:
        """weight * y_h added onto both masters of every h, summed per
        master in a fixed order; the hanging entries are left as they
        are."""
        part = weight * y[:, self.hang]
        add = gather_sum(torch.cat([part, part], dim=1), self.fold_table)
        return y.index_copy(1, self.masters, y[:, self.masters] + add)

    def ct_fold(self, y: torch.Tensor) -> torch.Tensor:
        """C^T, embedded: the hanging rows folded onto their masters, then
        zero."""
        return self.pin(self.fold(y, 0.5))

    def pin(self, x: torch.Tensor) -> torch.Tensor:
        """x with zeros on the hanging entries."""
        return x.index_fill(1, self.hang, 0.0)

    def fold_diagonal(self, D: torch.Tensor) -> torch.Tensor:
        """The block-Jacobi diagonal (V, V, N) of C^T A C: each hanging
        block's quarter onto both masters, identity blocks on the hanging
        rows (so iterates stay zero there)."""
        V = D.shape[0]
        D = self.fold(D.reshape(V * V, -1), 0.25)
        eye = torch.eye(V, dtype=D.dtype, device=D.device).reshape(V * V, 1)
        D = D.index_copy(1, self.hang,
                         eye.expand(V * V, self.n_hanging).contiguous())
        return D.reshape(V, V, -1)
