"""Synthetic structured box meshes (NumPy copies of
rdcfes_tpu.mesh.generators.box_tet_mesh and box_hex_mesh, bit-identical
output).

Boundary ids by cube face follow the vendored cube.msh side sets:
0..5 = z-min, y-min, x-max, y-max, x-min, z-max.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core import Mesh

_FACE_IDS = {"zmin": 0, "ymin": 1, "xmax": 2, "ymax": 3, "xmin": 4, "zmax": 5}


def _grid(nx: int, ny: int, nz: int, bounds) -> Tuple[np.ndarray, object]:
    (x0, x1), (y0, y1), (z0, z1) = bounds
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    return coords, nid


def box_hex_mesh(nx: int, ny: int, nz: int,
                 bounds=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))) -> Mesh:
    """Structured HEX8 box mesh with cube-convention boundary ids."""
    coords, nid = _grid(nx, ny, nz, bounds)
    conn = []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                conn.append([
                    nid(i, j, k), nid(i + 1, j, k),
                    nid(i + 1, j + 1, k), nid(i, j + 1, k),
                    nid(i, j, k + 1), nid(i + 1, j, k + 1),
                    nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1),
                ])
    mesh = Mesh(
        coords=coords,
        connectivity=np.asarray(conn, dtype=np.int32),
        elem_type="HEX8",
        subdomain_id=np.zeros(len(conn), dtype=np.int32),
    )
    _assign_box_boundary_ids(mesh, bounds)
    return mesh


def box_tet_mesh(nx: int, ny: int, nz: int,
                 bounds=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))) -> Mesh:
    """Structured TET4 box mesh: each hex cell split into 6 tets (Kuhn
    triangulation around the v0 -> v6 diagonal; positively oriented and
    conforming across cells)."""
    coords, nid = _grid(nx, ny, nz, bounds)
    hexv = lambda i, j, k: [
        nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k), nid(i, j + 1, k),
        nid(i, j, k + 1), nid(i + 1, j, k + 1), nid(i + 1, j + 1, k + 1),
        nid(i, j + 1, k + 1),
    ]
    tets_of_hex = [
        (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
        (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
    ]
    conn = []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                v = hexv(i, j, k)
                for t in tets_of_hex:
                    conn.append([v[t[0]], v[t[1]], v[t[2]], v[t[3]]])
    mesh = Mesh(
        coords=coords,
        connectivity=np.asarray(conn, dtype=np.int32),
        elem_type="TET4",
        subdomain_id=np.zeros(len(conn), dtype=np.int32),
    )
    _assign_box_boundary_ids(mesh, bounds)
    return mesh


def _assign_box_boundary_ids(mesh: Mesh, bounds) -> None:
    (x0, x1), (y0, y1), (z0, z1) = bounds
    tol = 1e-10 * max(x1 - x0, y1 - y0, z1 - z0, 1.0)
    fc = mesh.coords[mesh.boundary_faces].mean(axis=1)  # face centroids
    bid = mesh.boundary_id
    bid[np.abs(fc[:, 2] - z0) < tol] = _FACE_IDS["zmin"]
    bid[np.abs(fc[:, 1] - y0) < tol] = _FACE_IDS["ymin"]
    bid[np.abs(fc[:, 0] - x1) < tol] = _FACE_IDS["xmax"]
    bid[np.abs(fc[:, 1] - y1) < tol] = _FACE_IDS["ymax"]
    bid[np.abs(fc[:, 0] - x0) < tol] = _FACE_IDS["xmin"]
    bid[np.abs(fc[:, 2] - z1) < tol] = _FACE_IDS["zmax"]
