"""Batched isoparametric geometry factors in torch (channel-first layouts).

Replaces the per-element `fe->reinit(elem)` of the reference app: for every
element at once, the Jacobian of the reference -> physical map, JxW and the
physical shape-function gradients, in the same unrolled order as
rdcfes_tpu.fem.geometry.geometry_factors; and the boundary-face geometry
of `fe_face->reinit(elem, side)` (face_geometry_factors).  Everything is
computed in the coordinates' dtype (f32 or f64), so positions that change
every Newton iteration go through the same code.

Shapes: phi (Q, K) host table; JxW (Q, E); dphi (Q, K, 3, E).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import elements

_VOLUME_TYPES = ("TET4", "HEX8")
_FACE_TYPES = ("TRI3", "QUAD4")


def _inv3x3_cf(J: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-first 3x3 inverse: J (..., 3, 3, E) -> (inv, det (..., E))."""
    a = J[..., 0, 0, :]; b = J[..., 0, 1, :]; c = J[..., 0, 2, :]
    d = J[..., 1, 0, :]; e = J[..., 1, 1, :]; f = J[..., 1, 2, :]
    g = J[..., 2, 0, :]; h = J[..., 2, 1, :]; i = J[..., 2, 2, :]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    r = 1.0 / det
    row0 = torch.stack([A * r, -(b * i - c * h) * r, (b * f - c * e) * r],
                       dim=-2)
    row1 = torch.stack([B * r, (a * i - c * g) * r, -(a * f - c * d) * r],
                       dim=-2)
    row2 = torch.stack([C * r, -(a * h - b * g) * r, (a * e - b * d) * r],
                       dim=-2)
    return torch.stack([row0, row1, row2], dim=-3), det


def geometry_factors(coords: torch.Tensor, connectivity: torch.Tensor,
                     elem_type: str
                     ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """Per-element quadrature geometry of a 3D mesh (TET4 or HEX8).

    coords (N, 3) float tensor; connectivity (E, K) integer tensor on the
    same device.  Returns phi (Q, K) NumPy, JxW (Q, E) and dphi
    (Q, K, 3, E) in coords' dtype and device."""
    if elem_type not in _VOLUME_TYPES:
        raise NotImplementedError(
            f"geometry_factors: {elem_type} comes with the generic "
            "path (ROADMAP queue 1 item 8)")
    phi_np, dN_np, w_np = elements.tabulate(elem_type)
    w = torch.as_tensor(w_np, dtype=coords.dtype, device=coords.device)
    X = coords.T[:, connectivity.T]  # (3, K, E)
    Q, K = phi_np.shape
    zero = torch.zeros_like(X[:, 0, :])
    J_rows = []
    for q in range(Q):
        rows = []
        for r in range(3):
            acc = None
            for k in range(K):
                c = float(dN_np[q, k, r])
                if c == 0.0:
                    continue
                term = c * X[:, k, :]  # (3, E)
                acc = term if acc is None else acc + term
            rows.append(zero if acc is None else acc)
        J_rows.append(torch.stack(rows, dim=1))  # (3, r, E)
    J = torch.stack(J_rows, dim=0)  # (Q, 3, 3, E): [q, d, r, e]
    Jinv, detJ = _inv3x3_cf(J)      # Jinv (Q, 3, 3, E): [q, r, d, e]
    JxW = detJ * w[:, None]
    dphi_q = []
    for q in range(Q):
        ks = []
        for k in range(K):
            acc = None
            for r in range(3):
                c = float(dN_np[q, k, r])
                if c == 0.0:
                    continue
                term = c * Jinv[q, r]  # (3, E)
                acc = term if acc is None else acc + term
            ks.append(torch.zeros_like(Jinv[q, 0]) if acc is None else acc)
        dphi_q.append(torch.stack(ks, dim=0))  # (K, 3, E)
    return phi_np, JxW, torch.stack(dphi_q, dim=0)


def face_geometry_factors(coords: torch.Tensor, faces: torch.Tensor,
                          face_type: str):
    """Per-boundary-face quadrature geometry of TRI3 or QUAD4 faces of a
    3D mesh (face-batch-leading layout, as the reference).

    coords (N, 3) float tensor; faces (F, Kf) integer tensor.  Returns
    (psi (Q, Kf), JxW (F, Q), xyz (F, Q, 3), normals (F, Q, 3)), all in
    coords' dtype and device."""
    if face_type not in _FACE_TYPES:
        raise NotImplementedError(
            f"face_geometry_factors: {face_type} faces come with the "
            "generic path (ROADMAP queue 1 item 8)")
    psi_np, dN_np, w_np = elements.tabulate(face_type)
    tab = lambda a: torch.as_tensor(a, dtype=coords.dtype,
                                    device=coords.device)
    psi, dN, w = tab(psi_np), tab(dN_np), tab(w_np)
    X = coords[faces]                                   # (F, Kf, 3)
    T = torch.einsum("fkd,qkr->fqdr", X, dN)            # (F, Q, 3, 2)
    n = torch.linalg.cross(T[..., 0], T[..., 1], dim=-1)
    area_J = torch.linalg.vector_norm(n, dim=-1)
    normals = n / area_J[..., None]
    JxW = area_J * w[None, :]
    xyz = torch.einsum("qk,fkd->fqd", psi, X)
    return psi, JxW, xyz, normals
