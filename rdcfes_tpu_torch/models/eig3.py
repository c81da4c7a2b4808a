"""Batched symmetric 3x3 eigendecomposition and the stress invariants of
the solid post-processor (torch port of rdcfes_tpu.models.eig3).

The reference app runs JAMA's tred2/tql2 (src/eig3.C:25-271, used by
src/solid_system.C:509-520); here, as in the reference, the eigenvalues
come from the closed-form trigonometric method (branch-free, batched) and
the eigenvectors from the best-conditioned cross product of the rows of
A - lambda I.  Eigenvalues ascend, as the reference app sorts them
(src/eig3.C:186-198).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues (..., 3) of symmetric A (..., 3, 3) by the
    trigonometric closed form (Smith's method)."""
    a00 = A[..., 0, 0]; a11 = A[..., 1, 1]; a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]; a12 = A[..., 1, 2]; a02 = A[..., 0, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00**2 + b11**2 + b22**2 + 2.0 * (a01**2 + a12**2 + a02**2)
    p = torch.sqrt(p2 / 6.0)
    p_safe = torch.where(p == 0.0, 1.0, p)
    # det(B / p) / 2
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * p_safe**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    lam = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    return torch.where(p[..., None] == 0.0,
                       torch.stack([a00, a11, a22], dim=-1), lam)


def eigh3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., 3), eigenvectors as COLUMNS
    (..., 3, 3)) of symmetric A (..., 3, 3): each of the outer two
    vectors the largest of the three cross products of rows of
    A - lambda I, the middle one their cross product; a degenerate
    (repeated-eigenvalue) case falls back to an orthogonal complement."""
    lam = eigvalsh3(A)
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)

    def one_vector(lami):
        B = A - lami[..., None, None] * eye
        r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
        stacked = torch.stack([torch.linalg.cross(r0, r1),
                               torch.linalg.cross(r0, r2),
                               torch.linalg.cross(r1, r2)], dim=-2)
        best = torch.argmax((stacked**2).sum(dim=-1), dim=-1)
        v = torch.take_along_dim(stacked, best[..., None, None],
                                 dim=-2)[..., 0, :]
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return v / torch.where(nv == 0.0, 1.0, nv), nv[..., 0]

    v0, n0 = one_vector(lam[..., 0])
    v2, n2 = one_vector(lam[..., 2])
    # fully degenerate / axis-aligned cases
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype,
                      device=A.device).expand(v0.shape)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype,
                      device=A.device).expand(v2.shape)
    v0 = torch.where((n0 == 0.0)[..., None], ex, v0)
    v2 = torch.where((n2 == 0.0)[..., None], ez, v2)
    # v2 orthogonal to v0 (repeated eigenvalues)
    v2 = v2 - (v2 * v0).sum(dim=-1, keepdim=True) * v0
    nv2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    fallback = torch.linalg.cross(v0, ex + 0.5)  # a non-parallel helper
    nf = torch.linalg.vector_norm(fallback, dim=-1, keepdim=True)
    v2 = torch.where(nv2 < 1e-12,
                     fallback / torch.where(nf == 0.0, 1.0, nf),
                     v2 / torch.where(nv2 == 0.0, 1.0, nv2))
    v1 = torch.linalg.cross(v2, v0)
    return lam, torch.stack([v0, v1, v2], dim=-1)  # columns


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
