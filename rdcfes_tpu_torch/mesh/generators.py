"""Synthetic structured box meshes (NumPy copies of
rdcfes_tpu.mesh.generators.box_tet_mesh, box_hex_mesh, box_mixed_mesh,
box_quad_mesh, box_tri_mesh and tet4_to_tet10, bit-identical output).

Boundary ids by cube face follow the vendored cube.msh side sets:
0..5 = z-min, y-min, x-max, y-max, x-min, z-max; a rectangle's edges take
the in-plane subset (y-min 1, x-max 2, y-max 3, x-min 4).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core import Mesh, MeshBlock, MixedMesh

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


def box_mixed_mesh(nx: int, ny: int, nz: int,
                   bounds=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))) -> MixedMesh:
    """Conforming mixed-type box mesh: a HEX8 zone (cells i < t), one
    PYRAMID5 + TET4 transition layer (i == t) and a Kuhn TET4 zone
    (i > t), t = nx // 2; nx >= 3.  Each transition cell is split into 5
    pyramids with their apex at the cell centre (quad bases mate the hex
    zone, the neighbouring cells' pyramids and the domain boundary) and 2
    tets whose shared-face diagonal matches the Kuhn zone.  Blocks in the
    order HEX8, PYRAMID5, TET4."""
    if nx < 3:
        raise ValueError("box_mixed_mesh needs nx >= 3 (hex | transition "
                         "| tet)")
    t = nx // 2
    coords, nid = _grid(nx, ny, nz, bounds)
    N_grid = coords.shape[0]

    hexv = lambda i, j, k: [
        nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k),
        nid(i, j + 1, k), nid(i, j, k + 1), nid(i + 1, j, k + 1),
        nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1),
    ]
    hex_conn = [hexv(i, j, k)
                for k in range(nz) for j in range(ny) for i in range(t)]
    tets_of_hex = [
        (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
        (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
    ]
    tet_conn = []
    for k in range(nz):
        for j in range(ny):
            for i in range(t + 1, nx):
                v = hexv(i, j, k)
                for tt in tets_of_hex:
                    tet_conn.append([v[tt[0]], v[tt[1]], v[tt[2]], v[tt[3]]])

    # transition layer: an apex node at each cell centre
    centers, pyr_conn = [], []
    for k in range(nz):
        for j in range(ny):
            v = hexv(t, j, k)
            c = N_grid + len(centers)
            centers.append(coords[v].mean(axis=0))
            # every quad face of the cell but x = 1 (HEX8 local faces
            # zmin, ymin, ymax, xmin, zmax) becomes a pyramid, its base
            # counterclockwise seen from the apex (the outward order
            # reversed)
            for fd in ((0, 3, 2, 1), (0, 1, 5, 4), (2, 3, 7, 6),
                       (3, 0, 4, 7), (4, 5, 6, 7)):
                pyr_conn.append([v[x] for x in fd][::-1] + [c])
            # the x = 1 face {1, 2, 6, 5}: two tets split along the
            # diagonal the Kuhn zone puts on its x = 0 face (v1-v6)
            tet_conn.append([v[1], v[2], v[6], c])
            tet_conn.append([v[1], v[6], v[5], c])
    coords = np.concatenate([coords, np.asarray(centers)], axis=0)

    def _fix_tets(conn):
        conn = np.asarray(conn, dtype=np.int32)
        X = coords[conn]
        vol6 = np.einsum("ei,ei->e",
                         np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]),
                         X[:, 3] - X[:, 0])
        flip = vol6 < 0
        conn[flip, 2], conn[flip, 3] = (conn[flip, 3].copy(),
                                        conn[flip, 2].copy())
        return conn

    def _fix_pyrs(conn):
        conn = np.asarray(conn, dtype=np.int32)
        X = coords[conn]
        # the signed volume ~ base normal . (apex - base centre)
        n = np.cross(X[:, 2] - X[:, 0], X[:, 3] - X[:, 1])
        s = np.einsum("ei,ei->e", n, X[:, 4] - X[:, :4].mean(axis=1))
        flip = s < 0
        conn[flip, 1], conn[flip, 3] = (conn[flip, 3].copy(),
                                        conn[flip, 1].copy())
        return conn

    blocks = [
        MeshBlock("HEX8", np.asarray(hex_conn, dtype=np.int32),
                  np.zeros(len(hex_conn), dtype=np.int32)),
        MeshBlock("PYRAMID5", _fix_pyrs(pyr_conn),
                  np.zeros(len(pyr_conn), dtype=np.int32)),
        MeshBlock("TET4", _fix_tets(tet_conn),
                  np.zeros(len(tet_conn), dtype=np.int32)),
    ]
    mesh = MixedMesh(coords=coords, blocks=blocks)
    _assign_box_boundary_ids(mesh, bounds)
    return mesh


def _grid2d(nx: int, ny: int, bounds):
    """Nodes of an (nx + 1) x (ny + 1) grid at z = 0, x fastest, and the
    (ny, nx) grid of each cell's lower-left node id."""
    (x0, x1), (y0, y1) = bounds
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    return coords, (j * (nx + 1) + i).reshape(-1)


def box_quad_mesh(nx: int, ny: int,
                  bounds=((0.0, 1.0), (0.0, 1.0))) -> Mesh:
    """Structured QUAD4 rectangle mesh (2D volume elements, z = 0), cells
    x fastest, each counter-clockwise from its lower-left node."""
    coords, v00 = _grid2d(nx, ny, bounds)
    w = nx + 1
    conn = np.stack([v00, v00 + 1, v00 + w + 1, v00 + w], axis=1)
    mesh = Mesh(coords=coords, connectivity=conn.astype(np.int32),
                elem_type="QUAD4",
                subdomain_id=np.zeros(len(conn), dtype=np.int32))
    _assign_rect_boundary_ids(mesh, bounds)
    return mesh


def box_tri_mesh(nx: int, ny: int,
                 bounds=((0.0, 1.0), (0.0, 1.0))) -> Mesh:
    """Structured TRI3 rectangle mesh: each quad cell split along its
    (i, j) -> (i+1, j+1) diagonal into two counter-clockwise triangles,
    the lower one first."""
    coords, v00 = _grid2d(nx, ny, bounds)
    w = nx + 1
    lower = np.stack([v00, v00 + 1, v00 + w + 1], axis=1)
    upper = np.stack([v00, v00 + w + 1, v00 + w], axis=1)
    conn = np.stack([lower, upper], axis=1).reshape(-1, 3)
    mesh = Mesh(coords=coords, connectivity=conn.astype(np.int32),
                elem_type="TRI3",
                subdomain_id=np.zeros(len(conn), dtype=np.int32))
    _assign_rect_boundary_ids(mesh, bounds)
    return mesh


def _assign_rect_boundary_ids(mesh: Mesh, bounds) -> None:
    (x0, x1), (y0, y1) = bounds
    tol = 1e-10 * max(x1 - x0, y1 - y0, 1.0)
    fc = mesh.coords[mesh.boundary_faces].mean(axis=1)  # edge midpoints
    bid = mesh.boundary_id
    bid[np.abs(fc[:, 1] - y0) < tol] = _FACE_IDS["ymin"]
    bid[np.abs(fc[:, 0] - x1) < tol] = _FACE_IDS["xmax"]
    bid[np.abs(fc[:, 1] - y1) < tol] = _FACE_IDS["ymax"]
    bid[np.abs(fc[:, 0] - x0) < tol] = _FACE_IDS["xmin"]


def tet4_to_tet10(mesh: Mesh) -> Mesh:
    """Second-order upgrade of a TET4 mesh: one new node per unique edge
    (Gmsh TET10 node order: vertices, then the mid-edge nodes (0,1),(1,2),
    (0,2),(0,3),(2,3),(1,3)).  Subdomain and boundary-condition ids carry
    over (the TRI6 boundary faces are matched to the TET4 faces by their
    corner key)."""
    if mesh.elem_type != "TET4":
        raise ValueError(f"tet4_to_tet10 takes a TET4 mesh, got "
                         f"{mesh.elem_type}")
    conn = mesh.connectivity.astype(np.int64)
    edges = np.array([(0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)])
    ev = np.sort(conn[:, edges], axis=-1)            # (E, 6, 2)
    uniq, inv = np.unique(ev.reshape(-1, 2), axis=0, return_inverse=True)
    mid = 0.5 * (mesh.coords[uniq[:, 0]] + mesh.coords[uniq[:, 1]])
    N = mesh.n_nodes
    coords = np.concatenate([mesh.coords, mid])
    conn10 = np.concatenate(
        [conn, N + inv.reshape(conn.shape[0], 6)], axis=1)
    out = Mesh(coords=coords, connectivity=conn10.astype(np.int32),
               elem_type="TET10", subdomain_id=mesh.subdomain_id.copy())
    if mesh.boundary_id is not None:
        old = {tuple(sorted(f)): bid
               for f, bid in zip(mesh.boundary_faces.tolist(),
                                 mesh.boundary_id.tolist())}
        for i, f in enumerate(out.boundary_faces.tolist()):
            bid = old.get(tuple(sorted(f[:3])))
            if bid is not None:
                out.boundary_id[i] = bid
    return out


def _assign_box_boundary_ids(mesh, bounds) -> None:
    (x0, x1), (y0, y1), (z0, z1) = bounds
    tol = 1e-10 * max(x1 - x0, y1 - y0, z1 - z0, 1.0)
    bf = mesh.boundary_faces
    valid = bf >= 0  # MixedMesh pads triangle faces with -1
    fc = (np.where(valid[..., None], mesh.coords[np.maximum(bf, 0)], 0.0)
          .sum(axis=1) / valid.sum(axis=1, keepdims=True))  # centroids
    bid = mesh.boundary_id
    bid[np.abs(fc[:, 2] - z0) < tol] = _FACE_IDS["zmin"]
    bid[np.abs(fc[:, 1] - y0) < tol] = _FACE_IDS["ymin"]
    bid[np.abs(fc[:, 0] - x1) < tol] = _FACE_IDS["xmax"]
    bid[np.abs(fc[:, 1] - y1) < tol] = _FACE_IDS["ymax"]
    bid[np.abs(fc[:, 0] - x0) < tol] = _FACE_IDS["xmin"]
    bid[np.abs(fc[:, 2] - z1) < tol] = _FACE_IDS["zmax"]
