"""Batched isoparametric geometry factors in torch (channel-first layouts).

Replaces the per-element `fe->reinit(elem)` of the reference app: for every
element at once, the Jacobian of the reference -> physical map, JxW and the
physical shape-function gradients, in the same unrolled order as
rdcfes_tpu.fem.geometry.geometry_factors; and the boundary-face geometry
of `fe_face->reinit(elem, side)` (face_geometry_factors).  Everything is
computed in the coordinates' dtype (f32 or f64), so positions that change
every Newton iteration go through the same code.

A 2D mesh (TRI3, QUAD4, QUAD8, QUAD9) takes the in-plane 2x2 Jacobian,
and its physical gradients are 3-vectors whose z is zero, so every
consumer keeps the 3D layout; its boundary sides (EDGE2, EDGE3) get the
in-plane outward normals.

Shapes: phi (Q, K) host table; JxW (Q, E); dphi (Q, K, 3, E).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import elements

_VOLUME_TYPES = ("TET4", "HEX8", "PRISM6", "PYRAMID5", "TET10", "HEX20",
                 "HEX27")
_2D_TYPES = ("TRI3", "QUAD4", "QUAD8", "QUAD9")
_FACE_TYPES = ("TRI3", "TRI6", "QUAD4", "QUAD8", "QUAD9")
_EDGE_TYPES = ("EDGE2", "EDGE3")


def _inv3x3(J: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 3x3 inverse and determinant, J (..., 3, 3) (the reference's
    _inv3x3), through _inv3x3_cf on one element."""
    inv, det = _inv3x3_cf(J[..., None])
    return inv[..., 0], det[..., 0]


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
    """Per-element quadrature geometry, on the general route: a Jacobian
    per quadrature point, whatever the element (a straight-sided TET10's
    is constant, but its dphi varies with q).  3D types: TET4, HEX8,
    PRISM6, PYRAMID5, TET10, HEX20, HEX27; 2D types (TRI3, QUAD4, QUAD8,
    QUAD9) through _geometry_factors_2d.

    coords (N, 3) float tensor; connectivity (E, K) integer tensor on the
    same device.  Returns phi (Q, K) NumPy, JxW (Q, E) and dphi
    (Q, K, 3, E) in coords' dtype and device."""
    phi_np, dN_np, w_np = elements.tabulate(elem_type)
    w = torch.as_tensor(w_np, dtype=coords.dtype, device=coords.device)
    if elem_type in _2D_TYPES:
        return _geometry_factors_2d(coords, connectivity, phi_np, dN_np, w)
    if elem_type not in _VOLUME_TYPES:
        raise ValueError(f"geometry_factors: no volume element "
                         f"{elem_type!r}")
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


def _geometry_factors_2d(coords, connectivity, phi_np, dN_np, w):
    """geometry_factors of a 2D mesh, in the same unrolled order as the
    reference's _geometry_factors_2d (rdcfes_tpu/fem/geometry.py:141-190):
    the in-plane 2x2 Jacobian from x and y (z is ignored), dphi
    (Q, K, 3, E) with dphi[:, :, 2] zero."""
    X = coords.T[:2][:, connectivity.T]  # (2, K, E)
    Q, K = phi_np.shape
    zero2 = torch.zeros_like(X[:, 0, :])
    J_rows = []
    for q in range(Q):
        rows = []
        for r in range(2):
            acc = None
            for k in range(K):
                c = float(dN_np[q, k, r])
                if c == 0.0:
                    continue
                term = c * X[:, k, :]  # (2, E)
                acc = term if acc is None else acc + term
            rows.append(zero2 if acc is None else acc)
        J_rows.append(torch.stack(rows, dim=1))  # (2, r, E)
    J = torch.stack(J_rows, dim=0)  # (Q, 2, 2, E): [q, d, r, e]
    a, b = J[:, 0, 0], J[:, 0, 1]
    c_, d = J[:, 1, 0], J[:, 1, 1]
    det = a * d - b * c_
    r_ = 1.0 / det
    # Jinv[q, r, d, e]
    Jinv = torch.stack([torch.stack([d * r_, -b * r_], dim=-2),
                        torch.stack([-c_ * r_, a * r_], dim=-2)], dim=-3)
    JxW = det * w[:, None]
    zero = torch.zeros_like(det[0])  # (E,)
    dphi_q = []
    for q in range(Q):
        ks = []
        for k in range(K):
            acc = None
            for r in range(2):
                cc = float(dN_np[q, k, r])
                if cc == 0.0:
                    continue
                term = cc * Jinv[q, r]  # (2, E)
                acc = term if acc is None else acc + term
            if acc is None:
                acc = torch.zeros_like(Jinv[q, 0])
            ks.append(torch.cat([acc, zero[None]], dim=0))  # (3, E)
        dphi_q.append(torch.stack(ks, dim=0))  # (K, 3, E)
    return phi_np, JxW, torch.stack(dphi_q, dim=0)


def face_geometry_factors(coords: torch.Tensor, faces: torch.Tensor,
                          face_type: str):
    """Per-boundary-face quadrature geometry (face-batch-leading layout,
    as the reference): TRI3, TRI6, QUAD4, QUAD8 or QUAD9 faces of a 3D
    mesh, or the EDGE2 or EDGE3 sides of a 2D mesh, whose outward normal
    is the in-plane right rotation of the edge tangent (the sides are
    listed counter-clockwise, mesh.core.ELEMENT_FACES) with a zero z.

    coords (N, 3) float tensor; faces (F, Kf) integer tensor.  Returns
    (psi (Q, Kf), JxW (F, Q), xyz (F, Q, 3), normals (F, Q, 3)), all in
    coords' dtype and device."""
    if face_type not in _FACE_TYPES + _EDGE_TYPES:
        raise ValueError(f"face_geometry_factors: no face type "
                         f"{face_type!r}")
    psi_np, dN_np, w_np = elements.tabulate(face_type)
    tab = lambda a: torch.as_tensor(a, dtype=coords.dtype,
                                    device=coords.device)
    psi, dN, w = tab(psi_np), tab(dN_np), tab(w_np)
    if face_type in _EDGE_TYPES:
        X2 = coords[faces][..., :2]                          # (F, Kf, 2)
        T = torch.einsum("fkd,qkr->fqdr", X2, dN)[..., 0]    # (F, Q, 2)
        length_J = torch.linalg.vector_norm(T, dim=-1)
        t_hat = T / length_J[..., None]
        n2 = torch.stack([t_hat[..., 1], -t_hat[..., 0]], dim=-1)
        pad = torch.zeros_like(length_J)[..., None]
        JxW = length_J * w[None, :]
        xyz2 = torch.einsum("qk,fkd->fqd", psi, X2)
        return (psi, JxW, torch.cat([xyz2, pad], dim=-1),
                torch.cat([n2, pad], dim=-1))
    X = coords[faces]                                   # (F, Kf, 3)
    T = torch.einsum("fkd,qkr->fqdr", X, dN)            # (F, Q, 3, 2)
    n = torch.linalg.cross(T[..., 0], T[..., 1], dim=-1)
    area_J = torch.linalg.vector_norm(n, dim=-1)
    normals = n / area_J[..., None]
    JxW = area_J * w[None, :]
    xyz = torch.einsum("qk,fkd->fqd", psi, X)
    return psi, JxW, xyz, normals
