"""Uniform 1:8 h-refinement of TET4 and HEX8 meshes with P1 prolongation
(host NumPy copy of rdcfes_tpu.mesh.refine, the same arrays).

The counterpart of libMesh's `MeshRefinement::uniformly_refine` /
`refine_and_coarsen_elements` + `EquationSystems::reinit` (C++ reference
src/pihna.C:805-840): refinement rebuilds the host topology (a new Mesh
and the P1 prolongation), and the device system is then rebuilt on the
new mesh.  Selective refinement lives beside it: bisection in
mesh/adapt.py, 1:8 with hanging-node constraints in mesh/constrain.py;
this module keeps the uniform split and the helpers they share.

TET4: 4 corner tets and 4 octahedron tets, the octahedron cut along its
shortest diagonal.  HEX8: the trilinear 27-point lattice, 8 child hexes.
Boundary-condition ids pass from each parent face to its 4 children.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from .core import ELEMENT_FACES, Mesh

_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)
_HEX_EDGES = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0],
     [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]], dtype=np.int64
)


class Refinement(NamedTuple):
    """Topology record of one uniform refinement step.

    prolong(u)          : P1-interpolate nodal (N_old, ...) -> (N_new, ...)
    restrict_elemental(v): parent elemental (E_old,) -> children (8*E_old,)
    """

    mesh: Mesh
    edge_nodes: np.ndarray            # (Ne, 2) parent node ids per edge node
    face_nodes: Optional[np.ndarray]  # (Nf, 4) parent node ids (HEX8 only)
    center_conn: Optional[np.ndarray]  # (E, 8) parent conn (HEX8 only)
    prolong: Callable[[np.ndarray], np.ndarray]
    restrict_elemental: Callable[[np.ndarray], np.ndarray]


def _unique_rows(rows: np.ndarray):
    """(M, k) int rows -> (unique_sorted_rows (U, k), inverse (M,))."""
    key = np.sort(rows, axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    return uniq, inv


def refine_uniform(mesh: Mesh) -> Refinement:
    if mesh.elem_type == "TET4":
        return _refine_tet(mesh)
    if mesh.elem_type == "HEX8":
        return _refine_hex(mesh)
    raise ValueError(f"unsupported element type {mesh.elem_type}")


def _propagate_boundary(mesh: Mesh, new_mesh_conn, elem_type, coords,
                        subdomain, child_face_keys, child_face_ids) -> Mesh:
    """Build the child mesh and assign boundary ids by face-key lookup."""
    m = Mesh(coords, new_mesh_conn, elem_type, subdomain)
    if len(child_face_keys):
        table = {tuple(k): int(i)
                 for k, i in zip(child_face_keys, child_face_ids)}
        ids = np.zeros(len(m.boundary_faces), dtype=np.int32)
        for f, face in enumerate(np.sort(m.boundary_faces, axis=1)):
            ids[f] = table.get(tuple(face), 0)
        m.boundary_id = ids
    return m


def _tri_children(face, mid):
    a, b, c = face
    mab, mbc, mca = mid[(a, b)], mid[(b, c)], mid[(c, a)]
    return [(a, mab, mca), (b, mbc, mab), (c, mca, mbc), (mab, mbc, mca)]


def _refine_tet(mesh: Mesh) -> Refinement:
    conn = mesh.connectivity.astype(np.int64)
    E, N = conn.shape[0], mesh.n_nodes

    edges = conn[:, _TET_EDGES].reshape(E * 6, 2)  # (E*6, 2)
    uniq_edges, inv = _unique_rows(edges)
    mid_ids = (N + inv).reshape(E, 6)  # element-local m01..m23 global ids

    coords = np.concatenate(
        [mesh.coords, mesh.coords[uniq_edges].mean(axis=1)], axis=0
    )

    v = conn  # (E, 4)
    m01, m02, m03, m12, m13, m23 = (mid_ids[:, i] for i in range(6))
    corner = [
        np.stack([v[:, 0], m01, m02, m03], axis=1),
        np.stack([m01, v[:, 1], m12, m13], axis=1),
        np.stack([m02, m12, v[:, 2], m23], axis=1),
        np.stack([m03, m13, m23, v[:, 3]], axis=1),
    ]

    # octahedron: pick the shortest of the three diagonals per element
    def d2(a, b):
        return ((coords[a] - coords[b]) ** 2).sum(axis=1)

    diags = np.stack([d2(m01, m23), d2(m02, m13), d2(m03, m12)], axis=1)
    choice = np.argmin(diags, axis=1)  # (E,)
    # equator cycles (skipping the two cross-diagonals of the quad)
    octa_sets = []
    for c, (p, q, eq) in enumerate((
        (m01, m23, (m02, m03, m13, m12)),
        (m02, m13, (m01, m03, m23, m12)),
        (m03, m12, (m01, m02, m23, m13)),
    )):
        tets = [np.stack([p, q, eq[i], eq[(i + 1) % 4]], axis=1)
                for i in range(4)]
        octa_sets.append(np.stack(tets, axis=1))  # (E, 4, 4)
    octa = np.select(
        [choice[:, None, None] == c for c in range(3)], octa_sets
    )  # (E, 4, 4)

    children = np.concatenate(
        [np.stack(corner, axis=1), octa], axis=1
    ).reshape(E * 8, 4)

    # fix orientation: swap last two nodes where the signed volume is negative
    X = coords[children]
    vol6 = np.einsum(
        "ei,ei->e",
        np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]),
        X[:, 3] - X[:, 0],
    )
    flip = vol6 < 0
    children[flip, 2], children[flip, 3] = (
        children[flip, 3].copy(), children[flip, 2].copy()
    )

    subdomain = np.repeat(mesh.subdomain_id, 8)

    # boundary propagation: each parent TRI3 face -> 4 children
    mid = {tuple(e): N + i for i, e in enumerate(uniq_edges)}
    mid.update({(b, a): i for (a, b), i in list(mid.items())})
    keys, ids = [], []
    for face, bid in zip(mesh.boundary_faces, mesh.boundary_id):
        for ch in _tri_children(tuple(int(x) for x in face), mid):
            keys.append(sorted(ch))
            ids.append(int(bid))
    new_mesh = _propagate_boundary(
        mesh, children.astype(np.int32), "TET4", coords, subdomain,
        np.asarray(keys, dtype=np.int64), np.asarray(ids, dtype=np.int32),
    )

    def prolong(u):
        u = np.asarray(u)
        return np.concatenate([u, u[uniq_edges].mean(axis=1)], axis=0)

    def restrict_elemental(vals):
        return np.repeat(np.asarray(vals), 8, axis=0)

    return Refinement(new_mesh, uniq_edges, None, None, prolong,
                      restrict_elemental)


def _refine_hex(mesh: Mesh) -> Refinement:
    conn = mesh.connectivity.astype(np.int64)
    E, N = conn.shape[0], mesh.n_nodes

    edges = conn[:, _HEX_EDGES].reshape(E * 12, 2)
    uniq_edges, inv_e = _unique_rows(edges)
    edge_ids = (N + inv_e).reshape(E, 12)
    Ne = len(uniq_edges)

    faces_def = ELEMENT_FACES["HEX8"]
    faces = np.stack([conn[:, list(f)] for f in faces_def], axis=1)
    uniq_faces, inv_f = _unique_rows(faces.reshape(E * 6, 4))
    face_ids = (N + Ne + inv_f).reshape(E, 6)
    Nf = len(uniq_faces)

    center_ids = N + Ne + Nf + np.arange(E)

    coords = np.concatenate([
        mesh.coords,
        mesh.coords[uniq_edges].mean(axis=1),
        mesh.coords[uniq_faces].mean(axis=1),
        mesh.coords[conn].mean(axis=1),
    ], axis=0)

    # 3x3x3 lattice of global node ids per element, lattice coords (a,b,c)
    # in {0,1,2}^3 = reference coords (a/2, b/2, c/2)
    corner_at = {(0, 0, 0): 0, (2, 0, 0): 1, (2, 2, 0): 2, (0, 2, 0): 3,
                 (0, 0, 2): 4, (2, 0, 2): 5, (2, 2, 2): 6, (0, 2, 2): 7}
    lat = np.empty((E, 3, 3, 3), dtype=np.int64)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                odd = (a % 2) + (b % 2) + (c % 2)
                if odd == 0:
                    lat[:, a, b, c] = conn[:, corner_at[(a, b, c)]]
                elif odd == 3:
                    lat[:, a, b, c] = center_ids
                elif odd == 1:
                    # edge point: the two adjacent corners
                    lo = tuple(x - (x % 2) for x in (a, b, c))
                    hi = tuple(x + (x % 2) for x in (a, b, c))
                    pair = np.sort(np.stack(
                        [conn[:, corner_at[lo]], conn[:, corner_at[hi]]],
                        axis=1), axis=1)
                    # match against the element's own 12 edges
                    own = np.sort(conn[:, _HEX_EDGES], axis=2)  # (E, 12, 2)
                    hit = np.argmax(
                        (own == pair[:, None, :]).all(axis=2), axis=1
                    )
                    lat[:, a, b, c] = edge_ids[np.arange(E), hit]
                else:  # odd == 2: face point — the 4 corners of that face
                    fixed = [i for i, x in enumerate((a, b, c)) if x % 2 == 0]
                    axis0 = fixed[0]
                    own = np.sort(faces.reshape(E, 6, 4), axis=2)
                    quad = []
                    for da in ((0, 2) if a % 2 else (a,)):
                        for db in ((0, 2) if b % 2 else (b,)):
                            for dc in ((0, 2) if c % 2 else (c,)):
                                quad.append(conn[:, corner_at[(da, db, dc)]])
                    quad = np.sort(np.stack(quad, axis=1), axis=1)
                    hit = np.argmax(
                        (own == quad[:, None, :]).all(axis=2), axis=1
                    )
                    lat[:, a, b, c] = face_ids[np.arange(E), hit]
                    del axis0

    children = []
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                children.append(np.stack([
                    lat[:, i, j, k], lat[:, i + 1, j, k],
                    lat[:, i + 1, j + 1, k], lat[:, i, j + 1, k],
                    lat[:, i, j, k + 1], lat[:, i + 1, j, k + 1],
                    lat[:, i + 1, j + 1, k + 1], lat[:, i, j + 1, k + 1],
                ], axis=1))
    children = np.stack(children, axis=1).reshape(E * 8, 8)
    subdomain = np.repeat(mesh.subdomain_id, 8)

    # boundary propagation: each parent QUAD4 face -> 4 children
    mid = {tuple(e): N + i for i, e in enumerate(uniq_edges)}
    mid.update({(b, a): i for (a, b), i in list(mid.items())})
    fctr = {tuple(f): N + Ne + i for i, f in enumerate(uniq_faces)}
    keys, ids = [], []
    for face, bid in zip(mesh.boundary_faces, mesh.boundary_id):
        a, b, c, d = (int(x) for x in face)
        fc = fctr[tuple(np.sort([a, b, c, d]))]
        mab, mbc = mid[(a, b)], mid[(b, c)]
        mcd, mda = mid[(c, d)], mid[(d, a)]
        for ch in ((a, mab, fc, mda), (b, mbc, fc, mab),
                   (c, mcd, fc, mbc), (d, mda, fc, mcd)):
            keys.append(sorted(ch))
            ids.append(int(bid))
    new_mesh = _propagate_boundary(
        mesh, children.astype(np.int32), "HEX8", coords, subdomain,
        np.asarray(keys, dtype=np.int64), np.asarray(ids, dtype=np.int32),
    )

    def prolong(u):
        u = np.asarray(u)
        return np.concatenate([
            u, u[uniq_edges].mean(axis=1), u[uniq_faces].mean(axis=1),
            u[conn].mean(axis=1),
        ], axis=0)

    def restrict_elemental(vals):
        return np.repeat(np.asarray(vals), 8, axis=0)

    return Refinement(new_mesh, uniq_edges, uniq_faces, conn, prolong,
                      restrict_elemental)


def refine_flagged(mesh: Mesh, refine_flags: np.ndarray,
                   threshold: float = 0.0) -> Optional[Refinement]:
    """Conforming refinement for a flagged element set (the PIHNA
    driver's HEX8 policy): refine uniformly when the flagged fraction
    exceeds `threshold`, otherwise leave the mesh unchanged (returns
    None).  Local 1:8 refinement without hanging-node constraints would
    propagate through shared edges until it floods the mesh."""
    frac = float(np.count_nonzero(refine_flags)) / max(1, mesh.n_elems)
    if frac > threshold:
        return refine_uniform(mesh)
    return None
