"""Stress invariants of the solid post-processor (torch port of
rdcfes_tpu.models.eig3.principal_stress_invariants, the only part of eig3
that post-processing uses)."""

from __future__ import annotations

from typing import Tuple

import torch


def principal_stress_invariants(sigma: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hydrostatic pressure, Von Mises stress) of symmetric sigma
    (..., 3, 3): p = (l0+l1+l2)/3 and VM = sqrt(l0^2+l1^2+l2^2 - l0 l1 -
    l0 l2 - l1 l2) (reference app src/solid_system.C:516-520), through the
    invariants, VM^2 = (3/2) sigma:sigma - I1^2 / 2."""
    I1 = sigma[..., 0, 0] + sigma[..., 1, 1] + sigma[..., 2, 2]
    p = I1 / 3.0
    s2 = torch.einsum("...ij,...ij->...", sigma, sigma)
    vm = torch.sqrt(torch.clamp(1.5 * s2 - 0.5 * I1**2, min=0.0))
    return p, vm
