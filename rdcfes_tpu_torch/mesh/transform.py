"""Mesh coordinate transforms: scale, translate, rotate (NumPy copy of
rdcfes_tpu.mesh.transform).

The node transform of the C++ reference's process_mesh utility
(src/process_mesh.C:136-148) and its rotate() helper (src/utils.h:305-318):
  xyz' = R_zyx(theta) @ (scale * xyz + translation).
"""

from __future__ import annotations

import numpy as np

from .core import Mesh


def rotation_matrix(theta_x: float, theta_y: float, theta_z: float
                    ) -> np.ndarray:
    """The composite rotation of src/utils.h:305-318 as a matrix:

    [[C_y C_z,  C_z S_x S_y - C_x S_z,  S_x S_z + C_x C_z S_y],
     [C_y S_z,  C_x C_z + S_x S_y S_z,  C_x S_y S_z - C_z S_x],
     [   -S_y,              C_y S_x,               C_x C_y   ]]
    """
    sx, cx = np.sin(theta_x), np.cos(theta_x)
    sy, cy = np.sin(theta_y), np.cos(theta_y)
    sz, cz = np.sin(theta_z), np.cos(theta_z)
    return np.array([
        [cy * cz, cz * sx * sy - cx * sz, sx * sz + cx * cz * sy],
        [cy * sz, cx * cz + sx * sy * sz, cx * sy * sz - cz * sx],
        [-sy, cy * sx, cx * cy],
    ])


def rotate(v: np.ndarray, theta_x: float, theta_y: float, theta_z: float
           ) -> np.ndarray:
    """Rotate point(s) v (..., 3), as utils.h's rotate()."""
    return np.asarray(v) @ rotation_matrix(theta_x, theta_y, theta_z).T


def transform_mesh(mesh: Mesh, scale: float = 1.0,
                   translate=(0.0, 0.0, 0.0),
                   rotate_deg=(0.0, 0.0, 0.0)) -> Mesh:
    """Scale, then translate, then rotate (angles in degrees), as
    process_mesh.C:136-148."""
    xyz = scale * mesh.coords + np.asarray(translate, dtype=np.float64)
    th = np.deg2rad(np.asarray(rotate_deg, dtype=np.float64))
    return mesh.with_coords(rotate(xyz, th[0], th[1], th[2]))
