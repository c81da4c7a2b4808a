"""Inverse-distance interpolation (torch copy of rdcfes_tpu.utils.ida).

The reference app's InverseDistanceAlgorithm (src/ida.h:5-48, defined
there and used by no driver): weights w_i = |x - x_i|^(-coeff),
normalised, applied to nodal data, batched over query points; a query
point on a node takes that node's value.
"""

from __future__ import annotations

import torch


def inverse_distance_interpolate(xyz: torch.Tensor, nodes: torch.Tensor,
                                 data: torch.Tensor,
                                 coeff: float = 2.0) -> torch.Tensor:
    """xyz (..., 3) query points; nodes (M, 3); data (M,) -> (...,)
    values, all on one device."""
    d = torch.linalg.vector_norm(xyz[..., None, :] - nodes, dim=-1)
    hit = d == 0.0
    w = torch.where(hit, torch.inf, d ** (-coeff))
    w = torch.where(torch.isinf(w), 0.0, w)  # hits (and overflows) weigh 0
    hit_val = data[torch.argmin(d, dim=-1)]
    interp = (w * data).sum(dim=-1) / w.sum(dim=-1)
    return torch.where(hit.any(dim=-1), hit_val, interp)
