"""Host-side unstructured-mesh container (NumPy copy of rdcfes_tpu.mesh.core).

The mesh lives on the host as plain NumPy struct-of-arrays; the device only
sees the tables built from it (coordinates, connectivity, gather tables).
Only single-type volume meshes are carried here (mixed meshes: ROADMAP
queue 1 item 13).
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
    "TET10": (
        (0, 2, 1, 6, 5, 4),
        (0, 1, 3, 4, 9, 7),
        (1, 2, 3, 5, 8, 9),
        (2, 0, 3, 6, 7, 8),
    ),
    "TRI3": ((0, 1), (1, 2), (2, 0)),
    "QUAD4": ((0, 1), (1, 2), (2, 3), (3, 0)),
}

NODES_PER_ELEM = {"TET4": 4, "HEX8": 8, "TET10": 10, "TRI3": 3, "QUAD4": 4}
# boundary-face element type of each volume type
FACE_TYPE = {"TET4": "TRI3", "HEX8": "QUAD4", "TET10": "TRI6",
             "TRI3": "EDGE2", "QUAD4": "EDGE2"}


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
        if self.elem_type not in NODES_PER_ELEM:
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

    def element_volumes(self) -> np.ndarray:
        """Exact element volumes (areas on TRI3/QUAD4): TET4 |det J| / 6,
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
        if self.elem_type in ("TRI3", "QUAD4"):
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
