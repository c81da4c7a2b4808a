"""Host-side unstructured-mesh containers (NumPy copy of
rdcfes_tpu.mesh.core).

The mesh lives on the host as plain NumPy struct-of-arrays; the device only
sees the tables built from it (coordinates, connectivity, gather tables).
`Mesh` carries one volume element type: TET4, HEX8, TET10, HEX20 or HEX27
in 3D, TRI3, QUAD4, QUAD8 or QUAD9 in 2D (a 2D mesh's boundary sides are
EDGE2 or EDGE3 rows; its nodes keep three coordinates, z constant);
`MixedMesh` carries several first-order types (TET4, HEX8, PRISM6,
PYRAMID5) as `MeshBlock`s over one node set, its elements in
block-concatenated order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Local faces of each element type, outward orientation (libMesh side
# numbering, as in rdcfes_tpu.mesh.core.ELEMENT_FACES)
ELEMENT_FACES: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "TET4": ((0, 2, 1), (0, 1, 3), (1, 2, 3), (2, 0, 3)),
    "HEX8": (
        (0, 3, 2, 1),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (3, 0, 4, 7),
        (4, 5, 6, 7),
    ),
    # mixed-mesh transition types (libMesh Prism6/Pyramid5 side numbering)
    "PRISM6": (
        (0, 2, 1),
        (0, 1, 4, 3),
        (1, 2, 5, 4),
        (2, 0, 3, 5),
        (3, 4, 5),
    ),
    "PYRAMID5": (
        (0, 1, 4),
        (1, 2, 4),
        (2, 3, 4),
        (3, 0, 4),
        (0, 3, 2, 1),
    ),
    # sides are TRI6: the TET4 corner face plus its three mid-edge nodes
    "TET10": (
        (0, 2, 1, 6, 5, 4),
        (0, 1, 3, 4, 9, 7),
        (1, 2, 3, 5, 8, 9),
        (2, 0, 3, 6, 7, 8),
    ),
    # 2D volume elements (counter-clockwise vertices): the sides are the
    # boundary edges, listed in the counter-clockwise traversal, so the
    # outward normal is the right rotation of the edge tangent
    # (fem.geometry's EDGE2 and EDGE3 branch)
    "TRI3": ((0, 1), (1, 2), (2, 0)),
    "QUAD4": ((0, 1), (1, 2), (2, 3), (3, 0)),
    # quadratic types: a side is its corner tuple followed by its Gmsh
    # mid-edge (and face-centre) nodes
    "HEX20": (
        (0, 3, 2, 1, 9, 13, 11, 8),
        (0, 1, 5, 4, 8, 12, 16, 10),
        (1, 2, 6, 5, 11, 14, 18, 12),
        (2, 3, 7, 6, 13, 15, 19, 14),
        (3, 0, 4, 7, 9, 10, 17, 15),
        (4, 5, 6, 7, 16, 18, 19, 17),
    ),
    "HEX27": (
        (0, 3, 2, 1, 9, 13, 11, 8, 20),
        (0, 1, 5, 4, 8, 12, 16, 10, 21),
        (1, 2, 6, 5, 11, 14, 18, 12, 23),
        (2, 3, 7, 6, 13, 15, 19, 14, 24),
        (3, 0, 4, 7, 9, 10, 17, 15, 22),
        (4, 5, 6, 7, 16, 18, 19, 17, 25),
    ),
    "QUAD8": ((0, 1, 4), (1, 2, 5), (2, 3, 6), (3, 0, 7)),
    "QUAD9": ((0, 1, 4), (1, 2, 5), (2, 3, 6), (3, 0, 7)),
}

NODES_PER_ELEM = {"TET4": 4, "HEX8": 8, "PRISM6": 6, "PYRAMID5": 5,
                  "TET10": 10, "TRI3": 3, "QUAD4": 4, "EDGE2": 2,
                  "TRI6": 6, "EDGE3": 3, "QUAD8": 8, "QUAD9": 9,
                  "HEX20": 20, "HEX27": 27}
# boundary-face element type of each volume type
FACE_TYPE = {"TET4": "TRI3", "HEX8": "QUAD4", "TET10": "TRI6",
             "TRI3": "EDGE2", "QUAD4": "EDGE2",
             "HEX20": "QUAD8", "HEX27": "QUAD9",
             "QUAD8": "EDGE3", "QUAD9": "EDGE3"}
# the element types of a single-type Mesh; PRISM6 and PYRAMID5 come only
# as MixedMesh blocks, and a MixedMesh block is first-order
_SINGLE_TYPES = ("TET4", "HEX8", "TET10", "TRI3", "QUAD4",
                 "HEX20", "HEX27", "QUAD8", "QUAD9")
_BLOCK_TYPES = ("TET4", "HEX8", "PRISM6", "PYRAMID5")
# the volume types of 2D meshes
_2D_TYPES = ("TRI3", "QUAD4", "QUAD8", "QUAD9")


@dataclasses.dataclass
class Mesh:
    """Host-side mesh (struct of NumPy arrays).

    coords        : (N, 3) float64 node coordinates
    connectivity  : (E, K) int32 element-to-node map
    elem_type     : one of NODES_PER_ELEM
    subdomain_id  : (E,) int32 region id per element
    boundary_faces: (F, Kf) int32 node ids of boundary side elements
    boundary_elem : (F,) int32 owning element of each boundary face
    boundary_side : (F,) int32 local side index within the owning element
    boundary_id   : (F,) int32 boundary-condition id of each face
    """

    coords: np.ndarray
    connectivity: np.ndarray
    elem_type: str
    subdomain_id: Optional[np.ndarray] = None
    boundary_faces: Optional[np.ndarray] = None
    boundary_elem: Optional[np.ndarray] = None
    boundary_side: Optional[np.ndarray] = None
    boundary_id: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.elem_type not in _SINGLE_TYPES:
            raise ValueError(f"unsupported element type {self.elem_type!r}")
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.connectivity = np.ascontiguousarray(self.connectivity,
                                                 dtype=np.int32)
        if self.connectivity.shape[1] != NODES_PER_ELEM[self.elem_type]:
            raise ValueError(
                f"{self.elem_type} needs {NODES_PER_ELEM[self.elem_type]} "
                f"nodes per element, got {self.connectivity.shape[1]}")
        if self.subdomain_id is None:
            self.subdomain_id = np.zeros(self.n_elems, dtype=np.int32)
        self.subdomain_id = np.ascontiguousarray(self.subdomain_id,
                                                 dtype=np.int32)
        if self.boundary_faces is None:
            faces, elems, sides = extract_boundary_faces(
                self.connectivity, self.elem_type)
            self.boundary_faces = faces
            self.boundary_elem = elems
            self.boundary_side = sides
            self.boundary_id = np.zeros(len(faces), dtype=np.int32)

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.connectivity.shape[0]

    @property
    def nodes_per_elem(self) -> int:
        return NODES_PER_ELEM[self.elem_type]

    @property
    def dim(self) -> int:
        return 2 if self.elem_type in _2D_TYPES else 3

    def with_coords(self, coords: np.ndarray) -> "Mesh":
        """The same mesh at other node positions."""
        return dataclasses.replace(self, coords=np.asarray(coords,
                                                           dtype=np.float64))

    def element_volumes(self) -> np.ndarray:
        """Exact element volumes (areas on a 2D mesh): TET4 |det J| / 6,
        the other types the integral of det J at the default quadrature,
        exact for trilinear hexes (rdcfes_tpu.mesh.core.element_volumes,
        bit-equal)."""
        X = self.coords[self.connectivity]  # (E, K, 3)
        if self.elem_type == "TET4":
            v0 = X[:, 1] - X[:, 0]
            v1 = X[:, 2] - X[:, 0]
            v2 = X[:, 3] - X[:, 0]
            return np.einsum("ei,ei->e", np.cross(v0, v1), v2) / 6.0
        from ..fem import elements

        qp, qw = elements.quadrature(self.elem_type)
        dN = elements.shape_gradients(self.elem_type, qp)  # (Q, K, d)
        if self.dim == 2:
            X = X[..., :2]  # areas from the in-plane 2x2 Jacobian
        J = np.einsum("ekd,qkr->eqdr", X, dN)
        return np.einsum("eq,q->e", np.linalg.det(J), qw)

    def subdomain_ids_present(self) -> np.ndarray:
        return np.unique(self.subdomain_id)

    def print_info(self) -> str:
        """The mesh summary the drivers print (the role of libMesh's
        mesh.print_info(), as rdcfes_tpu.mesh.core.print_info)."""
        return "\n".join([
            "Mesh Information:",
            f"  elem_type={self.elem_type}",
            f"  n_nodes={self.n_nodes}",
            f"  n_elems={self.n_elems}",
            f"  n_subdomains={len(self.subdomain_ids_present())}",
            "  n_boundary_faces="
            f"{0 if self.boundary_faces is None else len(self.boundary_faces)}",
        ])


@dataclasses.dataclass
class MeshBlock:
    """One element-type block of a MixedMesh: its connectivity into the
    shared node set and its subdomain ids."""

    elem_type: str
    connectivity: np.ndarray  # (Eb, Kb) int32
    subdomain_id: Optional[np.ndarray] = None  # (Eb,) int32

    def __post_init__(self):
        if self.elem_type not in _BLOCK_TYPES:
            raise ValueError(
                f"MixedMesh blocks are first-order ({_BLOCK_TYPES}), got "
                f"{self.elem_type!r}")
        self.connectivity = np.ascontiguousarray(self.connectivity,
                                                 dtype=np.int32)
        if self.connectivity.shape[1] != NODES_PER_ELEM[self.elem_type]:
            raise ValueError(
                f"{self.elem_type} needs {NODES_PER_ELEM[self.elem_type]} "
                f"nodes per element, got {self.connectivity.shape[1]}")
        if self.subdomain_id is None:
            self.subdomain_id = np.zeros(len(self.connectivity),
                                         dtype=np.int32)
        self.subdomain_id = np.ascontiguousarray(self.subdomain_id,
                                                 dtype=np.int32)

    @property
    def n_elems(self) -> int:
        return self.connectivity.shape[0]


def _padded_faces(conn: np.ndarray, elem_type: str) -> np.ndarray:
    """All (element, side) faces as (E, S, 4), triangles padded with -1:
    one keying layout across the face arities of a mixed mesh."""
    rows = []
    for fd in ELEMENT_FACES[elem_type]:
        f = conn[:, list(fd)].astype(np.int32)
        if f.shape[1] == 3:
            f = np.concatenate([f, np.full((len(f), 1), -1, np.int32)],
                               axis=1)
        rows.append(f)
    return np.stack(rows, axis=1)


@dataclasses.dataclass
class MixedMesh:
    """A mesh of several element-type blocks over one node set.

    The boundary is extracted over all blocks: a face shared by two blocks
    (a pyramid's quad against a hex's) is interior.  Faces are stored
    padded with -1 to 4 nodes; boundary_block and boundary_elem name the
    owning (block, element within the block).  The global element order
    (IC files, VTU cells, CSV masks) is the blocks' concatenation.
    `elem_type` is "MIXED"."""

    coords: np.ndarray
    blocks: list
    boundary_faces: Optional[np.ndarray] = None   # (F, 4), -1 pad
    boundary_block: Optional[np.ndarray] = None
    boundary_elem: Optional[np.ndarray] = None
    boundary_side: Optional[np.ndarray] = None
    boundary_id: Optional[np.ndarray] = None

    elem_type = "MIXED"

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        if not self.blocks:
            raise ValueError("a MixedMesh needs at least one block")
        if self.boundary_faces is None:
            keys, blocks_of, elems_of, sides_of, faces_all = \
                [], [], [], [], []
            for bi, blk in enumerate(self.blocks):
                pf = _padded_faces(blk.connectivity, blk.elem_type)
                E, S, _ = pf.shape
                keys.append(np.sort(pf, axis=-1).reshape(E * S, 4))
                blocks_of.append(np.full(E * S, bi, np.int32))
                elems_of.append(np.repeat(np.arange(E, dtype=np.int32), S))
                sides_of.append(np.tile(np.arange(S, dtype=np.int32), E))
                faces_all.append(pf.reshape(E * S, 4))
            keys = np.concatenate(keys)
            _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                                       return_counts=True)
            sel = counts[inv.reshape(-1)] == 1
            self.boundary_faces = np.concatenate(faces_all)[sel]
            self.boundary_block = np.concatenate(blocks_of)[sel]
            self.boundary_elem = np.concatenate(elems_of)[sel]
            self.boundary_side = np.concatenate(sides_of)[sel]
            self.boundary_id = np.zeros(int(sel.sum()), dtype=np.int32)

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return sum(b.n_elems for b in self.blocks)

    @property
    def dim(self) -> int:
        return 3

    @property
    def subdomain_id(self) -> np.ndarray:
        """Per-element subdomain ids, concatenated in block order."""
        return np.concatenate([b.subdomain_id for b in self.blocks])

    def subdomain_ids_present(self) -> np.ndarray:
        return np.unique(self.subdomain_id)

    def element_volumes(self) -> np.ndarray:
        """Volumes per element in block order: the integral of det J at
        each type's default quadrature (exact for the affine and trilinear
        first-order types; rdcfes_tpu.mesh.core.MixedMesh.element_volumes,
        bit-equal)."""
        from ..fem import elements

        out = []
        for b in self.blocks:
            X = self.coords[b.connectivity]
            qp, qw = elements.quadrature(b.elem_type)
            dN = elements.shape_gradients(b.elem_type, qp)
            J = np.einsum("ekd,qkr->eqdr", X, dN)
            out.append(np.einsum("eq,q->e", np.linalg.det(J), qw))
        return np.concatenate(out)

    def with_coords(self, coords: np.ndarray) -> "MixedMesh":
        """The same mesh at other node positions."""
        return dataclasses.replace(self, coords=np.asarray(coords,
                                                           dtype=np.float64))

    def print_info(self) -> str:
        census = ", ".join(f"{b.n_elems} {b.elem_type}" for b in self.blocks)
        return "\n".join([
            "Mesh Information:",
            "  elem_type=MIXED (" + census + ")",
            f"  n_nodes={self.n_nodes}",
            f"  n_elems={self.n_elems}",
            f"  n_subdomains={len(self.subdomain_ids_present())}",
            f"  n_boundary_faces={len(self.boundary_faces)}",
        ])


def element_blocks(mesh):
    """(elem_type, connectivity) of each block of `mesh` in the global
    element order: the blocks of a MixedMesh, or a single-type mesh's one
    block."""
    if mesh.elem_type == "MIXED":
        return [(b.elem_type, b.connectivity) for b in mesh.blocks]
    return [(mesh.elem_type, mesh.connectivity)]


def extract_boundary_faces(
    connectivity: np.ndarray, elem_type: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Element faces not shared with a neighbour: every (element, side)
    face hashed by its sorted node ids; faces whose key appears once.

    Returns (faces [F, Kf] outward-ordered, elem_ids [F], side_ids [F])."""
    conn = np.asarray(connectivity)
    faces_def = ELEMENT_FACES[elem_type]
    n_sides = len(faces_def)
    E = conn.shape[0]
    all_faces = np.stack([conn[:, list(fd)] for fd in faces_def], axis=1)
    flat = all_faces.reshape(E * n_sides, all_faces.shape[-1])
    keys = np.sort(flat, axis=-1)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    idx = np.nonzero(counts[inv.reshape(-1)] == 1)[0]
    elem_ids = (idx // n_sides).astype(np.int32)
    side_ids = (idx % n_sides).astype(np.int32)
    return flat[idx].astype(np.int32), elem_ids, side_ids


def element_neighbors(connectivity: np.ndarray, elem_type: str) -> np.ndarray:
    """Neighbour element per (element, side), -1 on the boundary: faces
    keyed by sorted node ids and matched in pairs (libMesh's
    `elem->neighbor_ptr(s)`, as rdcfes_tpu.mesh.core.element_neighbors)."""
    conn = np.asarray(connectivity)
    faces_def = ELEMENT_FACES[elem_type]
    n_sides = len(faces_def)
    E = conn.shape[0]
    all_faces = np.stack([conn[:, list(fd)] for fd in faces_def], axis=1)
    flat = np.sort(all_faces.reshape(E * n_sides, all_faces.shape[-1]),
                   axis=-1)
    order = np.lexsort(flat.T[::-1])
    flat_sorted = flat[order]
    same_as_next = np.all(flat_sorted[:-1] == flat_sorted[1:], axis=1)
    neighbors = np.full(E * n_sides, -1, dtype=np.int64)
    a = order[:-1][same_as_next]
    b = order[1:][same_as_next]
    neighbors[a] = b // n_sides
    neighbors[b] = a // n_sides
    return neighbors.reshape(E, n_sides).astype(np.int32)
