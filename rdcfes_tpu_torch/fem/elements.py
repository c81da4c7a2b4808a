"""Lagrange reference elements and their quadrature (NumPy copy of
rdcfes_tpu.fem.elements: the same tables, bit for bit).

The degree-3 ("THIRD", libMesh's default for FIRST/LAGRANGE) rules:

* TET4 : 5-point Keast rule, centroid weight -2/15 and four
         (1/6, 1/6, 1/6)-type points of weight 3/40 (reference volume 1/6)
* HEX8 : 2x2x2 tensor Gauss (+-1/sqrt(3), unit weights)
* TRI3 face : 4-point rule, centroid w=-27/96 and three (1/5, 1/5)-type
         points w=25/96 (reference area 1/2)
* QUAD4 face: 2x2 tensor Gauss

The mixed-mesh transition types:

* PRISM6   : the TRI3 rule x 2-point Gauss in z (8 points; reference
             volume 1)
* PYRAMID5 : 2x2 Gauss in the base directions x 2-point Gauss-Jacobi with
             weight (1-z)^2 in z (8 points; reference volume 4/3).  The
             Jacobi weight absorbs the rational denominator of the pyramid
             basis, so mass and stiffness entries integrate exactly on
             affine pyramids.

and the second-order tet with its face:

* TET10 : Keast degree-5 14-point rule (all weights positive), exact past
          degree 4 as the P2 mass matrix needs (libMesh's FIFTH for p = 2)
* TRI6 face : Dunavant degree-5 7-point rule (all weights positive), so
          the P2 face integrands psi_i psi_j (degree 4) integrate exactly

TRI3 and QUAD4 are also the volume types of 2D meshes, whose boundary
sides are EDGE2 (2-point Gauss).  The quadratic types EDGE3, QUAD8, QUAD9,
HEX20 and HEX27 take the 3-point Gauss rule per direction and a nodal
basis from a Vandermonde solve over their Gmsh reference nodes
(`_NODAL_TYPES`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

_G3 = (-np.sqrt(0.6), 0.0, np.sqrt(0.6))
_W3 = (5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0)

_SQ3 = 1.0 / np.sqrt(3.0)
# vertex signs in the standard HEX8 / QUAD4 orderings
_SX8 = np.array([-1, 1, 1, -1, -1, 1, 1, -1])
_SY8 = np.array([-1, -1, 1, 1, -1, -1, 1, 1])
_SZ8 = np.array([-1, -1, -1, -1, 1, 1, 1, 1])
_SX4 = np.array([-1, 1, 1, -1])
_SY4 = np.array([-1, -1, 1, 1])


@lru_cache(maxsize=None)
def quadrature(elem_type: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (points [Q, d], weights [Q]) on the reference element."""
    if elem_type == "TET4":
        a, b = 1.0 / 6.0, 0.5
        pts = np.array([[0.25, 0.25, 0.25], [a, a, a], [a, a, b], [a, b, a],
                        [b, a, a]])
        wts = np.array([-2.0 / 15.0, 3.0 / 40.0, 3.0 / 40.0, 3.0 / 40.0,
                        3.0 / 40.0])
        return pts, wts
    if elem_type == "HEX8":
        g = [-_SQ3, _SQ3]
        pts = np.array([[x, y, z] for z in g for y in g for x in g])
        return pts, np.ones(8)
    if elem_type == "TRI3":
        pts = np.array([[1.0 / 3.0, 1.0 / 3.0], [0.2, 0.2], [0.6, 0.2],
                        [0.2, 0.6]])
        wts = np.array([-27.0 / 96.0, 25.0 / 96.0, 25.0 / 96.0,
                        25.0 / 96.0])
        return pts, wts
    if elem_type == "TRI6":
        # Dunavant degree-5, 7 points; reference area 1/2, so the
        # area-normalised weights halve
        a1, w1 = 0.4701420641051151, 0.1323941527885062
        a2, w2 = 0.1012865073234563, 0.1259391805448271
        pts = [[1.0 / 3.0, 1.0 / 3.0]]
        wts = [0.225]
        for a, w in ((a1, w1), (a2, w2)):
            c = 1.0 - 2.0 * a
            pts += [[a, a], [c, a], [a, c]]
            wts += [w] * 3
        return np.asarray(pts), 0.5 * np.asarray(wts)
    if elem_type == "QUAD4":
        g = [-_SQ3, _SQ3]
        return np.array([[x, y] for y in g for x in g]), np.ones(4)
    if elem_type == "EDGE2":
        return np.array([[-_SQ3], [_SQ3]]), np.ones(2)
    if elem_type == "EDGE3":
        return np.array([[g] for g in _G3]), np.array(_W3)
    if elem_type in ("QUAD8", "QUAD9"):
        pts = np.array([[x, y] for y in _G3 for x in _G3])
        wts = np.array([wy * wx for wy in _W3 for wx in _W3])
        return pts, wts
    if elem_type in ("HEX20", "HEX27"):
        pts = np.array([[x, y, z] for z in _G3 for y in _G3 for x in _G3])
        wts = np.array([wz * wy * wx for wz in _W3 for wy in _W3
                        for wx in _W3])
        return pts, wts
    if elem_type == "PRISM6":
        # triangle degree-3 rule x 2-point Gauss on z in [-1, 1]
        tpts, twts = quadrature("TRI3")
        pts = np.array([[x, y, z] for z in (-_SQ3, _SQ3)
                        for (x, y) in tpts])
        wts = np.array([w for _ in range(2) for w in twts])
        return pts, wts
    if elem_type == "TET10":
        # Keast degree-5 14-point rule
        a1, c1, w1 = 0.3108859192633005, 0.0673422422100983, \
            0.018781320953002642
        a2, c2, w2 = 0.09273525031089123, 0.7217942490673263, \
            0.012248840519393658
        a3, b3, w3 = 0.04550370412564965, 0.45449629587435036, \
            0.007091003462846911
        pts, wts = [], []
        for (a, c, w) in ((a1, c1, w1), (a2, c2, w2)):
            # barycentric (a, a, a, c) orbit: c in each slot
            bary = [(c, a, a, a), (a, c, a, a), (a, a, c, a), (a, a, a, c)]
            pts += [[x, y, z] for (_, x, y, z) in bary]
            wts += [w] * 4
        # barycentric (a, a, b, b) orbit: 6 placements of the two b's
        for i in range(3):
            for j in range(i + 1, 4):
                bl = [a3] * 4
                bl[i] = bl[j] = b3
                pts.append(bl[1:])
                wts.append(w3)
        return np.array(pts), np.array(wts)
    if elem_type != "PYRAMID5":
        raise ValueError(f"unsupported element type {elem_type!r}")
    # PYRAMID5.  z: 2-point Gauss-Jacobi for int_0^1 (1-z)^2 f(z) dz (the
    # moment equations of the weight t^2, t = 1 - z: p2(t) = t^2 - 4/3 t
    # + 2/5); the base points scale with (1 - z), the conical (Duffy) map
    # from the cube whose (1-z)^2 Jacobian the Jacobi weights carry
    t = 2.0 / 3.0 + np.array([-1.0, 1.0]) * np.sqrt(2.0 / 45.0)
    m0, m1 = 1.0 / 3.0, 1.0 / 4.0
    w1 = (m1 - m0 * t[1]) / (t[0] - t[1])
    zw = np.array([w1, m0 - w1])
    z = 1.0 - t
    g = [-_SQ3, _SQ3]
    pts = np.array([[a * (1 - zz), b * (1 - zz), zz]
                    for zz in z for b in g for a in g])
    wts = np.array([wz for wz in zw for _ in range(4)])
    return pts, wts


def shape_functions(elem_type: str, pts: np.ndarray) -> np.ndarray:
    """phi [Q, K]: Lagrange shape functions at reference points."""
    pts = np.atleast_2d(pts)
    if elem_type in _NODAL_TYPES:
        return _nodal_shape(elem_type, pts)
    if elem_type == "TET4":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        return np.stack([1.0 - x - y - z, x, y, z], axis=1)
    if elem_type == "HEX8":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        return ((1 + x[:, None] * _SX8) * (1 + y[:, None] * _SY8)
                * (1 + z[:, None] * _SZ8) / 8.0)
    if elem_type == "PRISM6":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        L = np.stack([1.0 - x - y, x, y], axis=1)  # (Q, 3)
        lo = (1.0 - z[:, None]) / 2.0
        hi = (1.0 + z[:, None]) / 2.0
        return np.concatenate([L * lo, L * hi], axis=1)
    if elem_type == "TET10":
        # quadratic Lagrange, Gmsh node order: vertices 0..3, then the
        # mid-edge nodes (0,1),(1,2),(0,2),(0,3),(2,3),(1,3)
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        L0, L1, L2, L3 = 1.0 - x - y - z, x, y, z
        return np.stack([
            L0 * (2 * L0 - 1), L1 * (2 * L1 - 1),
            L2 * (2 * L2 - 1), L3 * (2 * L3 - 1),
            4 * L0 * L1, 4 * L1 * L2, 4 * L0 * L2,
            4 * L0 * L3, 4 * L2 * L3, 4 * L1 * L3,
        ], axis=1)
    if elem_type == "PYRAMID5":
        # rational first-order basis (libMesh Pyramid5 LAGRANGE): base
        # quad [-1,1]^2 at z=0, apex (0,0,1); s = 1-z.  At the apex
        # x = y = 0, so the guarded denominator leaves the exact limit 0.
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        s = 1.0 - z
        s4 = 4.0 * np.where(s == 0.0, 1.0, s)
        N0 = (s - x) * (s - y) / s4
        N1 = (s + x) * (s - y) / s4
        N2 = (s + x) * (s + y) / s4
        N3 = (s - x) * (s + y) / s4
        return np.stack([N0, N1, N2, N3, z], axis=1)
    if elem_type == "EDGE2":
        x = pts[:, 0]
        return np.stack([(1.0 - x) / 2.0, (1.0 + x) / 2.0], axis=1)
    x, y = pts[:, 0], pts[:, 1]
    if elem_type == "TRI3":
        return np.stack([1.0 - x - y, x, y], axis=1)
    if elem_type == "TRI6":
        # quadratic Lagrange triangle, Gmsh order: vertices 0..2, then the
        # mid-edge nodes (0,1),(1,2),(2,0): the TET10 face
        L0, L1, L2 = 1.0 - x - y, x, y
        return np.stack([
            L0 * (2 * L0 - 1), L1 * (2 * L1 - 1), L2 * (2 * L2 - 1),
            4 * L0 * L1, 4 * L1 * L2, 4 * L2 * L0,
        ], axis=1)
    if elem_type != "QUAD4":
        raise ValueError(f"unsupported element type {elem_type!r}")
    return (1 + x[:, None] * _SX4) * (1 + y[:, None] * _SY4) / 4.0


def shape_gradients(elem_type: str, pts: np.ndarray) -> np.ndarray:
    """dN [Q, K, d]: reference-coordinate gradients of the shape functions."""
    pts = np.atleast_2d(pts)
    if elem_type in _NODAL_TYPES:
        return _nodal_grads(elem_type, pts)
    Q = pts.shape[0]
    if elem_type == "TET4":
        dN = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                       [0.0, 0.0, 1.0]])
        return np.broadcast_to(dN, (Q, 4, 3)).copy()
    if elem_type == "HEX8":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        gx = _SX8 * (1 + y[:, None] * _SY8) * (1 + z[:, None] * _SZ8) / 8.0
        gy = (1 + x[:, None] * _SX8) * _SY8 * (1 + z[:, None] * _SZ8) / 8.0
        gz = (1 + x[:, None] * _SX8) * (1 + y[:, None] * _SY8) * _SZ8 / 8.0
        return np.stack([gx, gy, gz], axis=2)
    if elem_type == "TRI3":
        dN = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        return np.broadcast_to(dN, (Q, 3, 2)).copy()
    if elem_type == "EDGE2":
        dN = np.array([[-0.5], [0.5]])
        return np.broadcast_to(dN, (Q, 2, 1)).copy()
    if elem_type == "TRI6":
        x, y = pts[:, 0], pts[:, 1]
        L = [1.0 - x - y, x, y]
        dL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        cols = [(4 * L[i] - 1)[:, None] * dL[i] for i in range(3)]
        for (i, j) in ((0, 1), (1, 2), (2, 0)):
            cols.append(4 * (L[i][:, None] * dL[j] + L[j][:, None] * dL[i]))
        return np.stack(cols, axis=1)                     # (Q, 6, 2)
    if elem_type == "PRISM6":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        L = np.stack([1.0 - x - y, x, y], axis=1)       # (Q, 3)
        dL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
        lo = (1.0 - z) / 2.0
        hi = (1.0 + z) / 2.0
        gx = np.concatenate([dL[:, 0] * lo[:, None],
                             dL[:, 0] * hi[:, None]], axis=1)
        gy = np.concatenate([dL[:, 1] * lo[:, None],
                             dL[:, 1] * hi[:, None]], axis=1)
        gz = np.concatenate([-0.5 * L, 0.5 * L], axis=1)
        return np.stack([gx, gy, gz], axis=2)
    if elem_type == "TET10":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        L = [1.0 - x - y - z, x, y, z]                   # (4,) of (Q,)
        dL = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0],
                       [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])  # (4, 3)
        cols = [(4 * L[i] - 1)[:, None] * dL[i] for i in range(4)]
        for (i, j) in ((0, 1), (1, 2), (0, 2),            # mid-edge nodes
                       (0, 3), (2, 3), (1, 3)):
            cols.append(4 * (L[i][:, None] * dL[j] + L[j][:, None] * dL[i]))
        return np.stack(cols, axis=1)                     # (Q, 10, 3)
    if elem_type == "PYRAMID5":
        # singular AT the apex (standard for Pyramid5 LAGRANGE); the
        # quadrature points are interior, the guard only keeps z == 1
        # from giving NaN
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        s = np.where(z == 1.0, 1.0, 1.0 - z)
        q = x * y / (4.0 * s * s)
        gx = np.stack([-(s - y), (s - y), (s + y), -(s + y),
                       np.zeros_like(s)], axis=1) / (4.0 * s)[:, None]
        gy = np.stack([-(s - x), -(s + x), (s + x), (s - x),
                       np.zeros_like(s)], axis=1) / (4.0 * s)[:, None]
        gz = np.stack([-0.25 + q, -0.25 - q, -0.25 + q, -0.25 - q,
                       np.ones_like(s)], axis=1)
        return np.stack([gx, gy, gz], axis=2)
    if elem_type != "QUAD4":
        raise ValueError(f"unsupported element type {elem_type!r}")
    x, y = pts[:, 0], pts[:, 1]
    gx = _SX4 * (1 + y[:, None] * _SY4) / 4.0
    gy = (1 + x[:, None] * _SX4) * _SY4 / 4.0
    return np.stack([gx, gy], axis=2)


# The quadratic types EDGE3, QUAD8, QUAD9, HEX20 and HEX27: for each, the
# reference node coordinates in Gmsh node order and a monomial exponent
# set spanning its polynomial space; the nodal basis coefficients are the
# rows of V^-T (V the Vandermonde matrix of the monomials at the nodes),
# and the gradients come from differentiating the monomials.
def _hex_ref_nodes(n20: bool):
    corners = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
               (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    # Gmsh hex edge order (lower-index-first pairs)
    edges = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
             (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]
    nodes = list(corners)
    for a, b in edges:
        nodes.append(tuple((np.array(corners[a]) + corners[b]) / 2.0))
    if n20:
        return nodes
    # Gmsh hex face order, then the body centre
    faces = [(0, 3, 2, 1), (0, 1, 5, 4), (0, 4, 7, 3),
             (1, 2, 6, 5), (2, 3, 7, 6), (4, 5, 6, 7)]
    for f in faces:
        nodes.append(tuple(np.mean([corners[i] for i in f], axis=0)))
    nodes.append((0.0, 0.0, 0.0))
    return nodes


def _serendipity3d_exps():
    """The 20-monomial serendipity space: complete quadratics plus the
    {a^2 b} and {a^2 b c} mixed terms."""
    exps = [(i, j, k) for i in range(2) for j in range(2) for k in range(2)]
    exps += [(2, 0, 0), (0, 2, 0), (0, 0, 2),
             (2, 1, 0), (2, 0, 1), (1, 2, 0), (0, 2, 1), (1, 0, 2),
             (0, 1, 2), (2, 1, 1), (1, 2, 1), (1, 1, 2)]
    return exps


_NODAL_TYPES = {
    "EDGE3": (
        [(-1.0,), (1.0,), (0.0,)],
        [(0,), (1,), (2,)],
    ),
    "QUAD8": (
        [(-1, -1), (1, -1), (1, 1), (-1, 1),
         (0, -1), (1, 0), (0, 1), (-1, 0)],
        [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 1), (1, 2)],
    ),
    "QUAD9": (
        [(-1, -1), (1, -1), (1, 1), (-1, 1),
         (0, -1), (1, 0), (0, 1), (-1, 0), (0, 0)],
        [(i, j) for i in range(3) for j in range(3)],
    ),
    "HEX20": (_hex_ref_nodes(True), _serendipity3d_exps()),
    "HEX27": (
        _hex_ref_nodes(False),
        [(i, j, k) for i in range(3) for j in range(3) for k in range(3)],
    ),
}


@lru_cache(maxsize=None)
def _nodal_coeffs(elem_type: str):
    nodes, exps = _NODAL_TYPES[elem_type]
    nodes = np.asarray(nodes, dtype=np.float64)
    V = np.stack([
        np.prod(nodes ** np.asarray(e, dtype=np.float64), axis=1)
        for e in exps
    ], axis=1)  # (K nodes, K monomials)
    return np.linalg.inv(V), nodes, [np.asarray(e) for e in exps]


def _nodal_shape(elem_type: str, pts: np.ndarray) -> np.ndarray:
    C, _, exps = _nodal_coeffs(elem_type)
    mono = np.stack([np.prod(pts ** e, axis=1) for e in exps], axis=1)
    return mono @ C  # (Q, K)


def _nodal_grads(elem_type: str, pts: np.ndarray) -> np.ndarray:
    C, _, exps = _nodal_coeffs(elem_type)
    out = []
    for r in range(pts.shape[1]):
        dm = []
        for e in exps:
            if e[r] == 0:
                dm.append(np.zeros(len(pts)))
                continue
            e2 = np.array(e, dtype=np.float64)
            e2[r] -= 1
            dm.append(e[r] * np.prod(pts ** e2, axis=1))
        out.append(np.stack(dm, axis=1) @ C)
    return np.stack(out, axis=2)  # (Q, K, d)


@lru_cache(maxsize=None)
def tabulate(elem_type: str):
    """(phi [Q,K], dN [Q,K,d], weights [Q]) at the default quadrature rule."""
    pts, wts = quadrature(elem_type)
    return shape_functions(elem_type, pts), shape_gradients(elem_type, pts), wts
