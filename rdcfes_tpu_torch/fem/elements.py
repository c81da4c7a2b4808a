"""P1 Lagrange TET4 reference element and its quadrature (NumPy copy of the
TET4 rows of rdcfes_tpu.fem.elements).

libMesh's `QGauss(3, THIRD)` on TET4 is the 5-point degree-3 Keast rule:
centroid weight -2/15 and four (1/6, 1/6, 1/6)-type points of weight 3/40
(reference volume 1/6).  Other element types come with the generic
(non-affine) path, ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


def _require_tet4(elem_type: str) -> None:
    if elem_type != "TET4":
        raise ValueError(f"unsupported element type {elem_type!r}")


@lru_cache(maxsize=None)
def quadrature(elem_type: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (points [Q, 3], weights [Q]) on the reference element."""
    _require_tet4(elem_type)
    a, b = 1.0 / 6.0, 0.5
    pts = np.array([[0.25, 0.25, 0.25], [a, a, a], [a, a, b], [a, b, a],
                    [b, a, a]])
    wts = np.array([-2.0 / 15.0, 3.0 / 40.0, 3.0 / 40.0, 3.0 / 40.0,
                    3.0 / 40.0])
    return pts, wts


def shape_functions(elem_type: str, pts: np.ndarray) -> np.ndarray:
    """phi [Q, K]: P1 Lagrange shape functions at reference points."""
    _require_tet4(elem_type)
    pts = np.atleast_2d(pts)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack([1.0 - x - y - z, x, y, z], axis=1)


def shape_gradients(elem_type: str, pts: np.ndarray) -> np.ndarray:
    """dN [Q, K, 3]: reference-coordinate gradients (constant on TET4)."""
    _require_tet4(elem_type)
    Q = np.atleast_2d(pts).shape[0]
    dN = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                   [0.0, 0.0, 1.0]])
    return np.broadcast_to(dN, (Q, 4, 3)).copy()


@lru_cache(maxsize=None)
def tabulate(elem_type: str):
    """(phi [Q,K], dN [Q,K,3], weights [Q]) at the default quadrature rule."""
    pts, wts = quadrature(elem_type)
    return shape_functions(elem_type, pts), shape_gradients(elem_type, pts), wts
