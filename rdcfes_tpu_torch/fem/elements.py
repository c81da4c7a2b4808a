"""P1 Lagrange reference elements and their quadrature (NumPy copy of the
TET4, HEX8, TRI3 and QUAD4 rows of rdcfes_tpu.fem.elements).

The degree-3 ("THIRD", libMesh's default for FIRST/LAGRANGE) rules:

* TET4 : 5-point Keast rule, centroid weight -2/15 and four
         (1/6, 1/6, 1/6)-type points of weight 3/40 (reference volume 1/6)
* HEX8 : 2x2x2 tensor Gauss (+-1/sqrt(3), unit weights)
* TRI3 face : 4-point rule, centroid w=-27/96 and three (1/5, 1/5)-type
         points w=25/96 (reference area 1/2)
* QUAD4 face: 2x2 tensor Gauss

Other element types come with the generic path (ROADMAP queue 1 item 8)
and the mixed meshes (item 13).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

_PORTED_TYPES = ("TET4", "HEX8", "TRI3", "QUAD4")

_SQ3 = 1.0 / np.sqrt(3.0)
# vertex signs in the standard HEX8 / QUAD4 orderings
_SX8 = np.array([-1, 1, 1, -1, -1, 1, 1, -1])
_SY8 = np.array([-1, -1, 1, 1, -1, -1, 1, 1])
_SZ8 = np.array([-1, -1, -1, -1, 1, 1, 1, 1])
_SX4 = np.array([-1, 1, 1, -1])
_SY4 = np.array([-1, -1, 1, 1])


def _require_ported(elem_type: str) -> None:
    if elem_type not in _PORTED_TYPES:
        raise ValueError(f"unsupported element type {elem_type!r}")


@lru_cache(maxsize=None)
def quadrature(elem_type: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (points [Q, d], weights [Q]) on the reference element."""
    _require_ported(elem_type)
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
    g = [-_SQ3, _SQ3]  # QUAD4
    return np.array([[x, y] for y in g for x in g]), np.ones(4)


def shape_functions(elem_type: str, pts: np.ndarray) -> np.ndarray:
    """phi [Q, K]: P1 Lagrange shape functions at reference points."""
    _require_ported(elem_type)
    pts = np.atleast_2d(pts)
    if elem_type == "TET4":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        return np.stack([1.0 - x - y - z, x, y, z], axis=1)
    if elem_type == "HEX8":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        return ((1 + x[:, None] * _SX8) * (1 + y[:, None] * _SY8)
                * (1 + z[:, None] * _SZ8) / 8.0)
    x, y = pts[:, 0], pts[:, 1]
    if elem_type == "TRI3":
        return np.stack([1.0 - x - y, x, y], axis=1)
    return (1 + x[:, None] * _SX4) * (1 + y[:, None] * _SY4) / 4.0  # QUAD4


def shape_gradients(elem_type: str, pts: np.ndarray) -> np.ndarray:
    """dN [Q, K, d]: reference-coordinate gradients of the shape functions."""
    _require_ported(elem_type)
    pts = np.atleast_2d(pts)
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
    x, y = pts[:, 0], pts[:, 1]  # QUAD4
    gx = _SX4 * (1 + y[:, None] * _SY4) / 4.0
    gy = (1 + x[:, None] * _SX4) * _SY4 / 4.0
    return np.stack([gx, gy], axis=2)


@lru_cache(maxsize=None)
def tabulate(elem_type: str):
    """(phi [Q,K], dN [Q,K,d], weights [Q]) at the default quadrature rule."""
    pts, wts = quadrature(elem_type)
    return shape_functions(elem_type, pts), shape_gradients(elem_type, pts), wts
