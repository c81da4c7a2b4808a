"""ParaView VTU / PVD writers for single-type 3D and 2D meshes and mixed
meshes (the files of rdcfes_tpu.io.vtu, byte for byte).

Output format of the C++ reference's Paraview_IO (src/paraview.h:12-248):
* ASCII .vtu: Points ("position"), PointData (node_ID, then every field
  in the caller's order), CellData (element_ID, region_ID, processor_ID),
  Cells (connectivity, offsets, VTK types);
* values with |x| <= 1e-24 written as 0 (src/paraview.h:96);
* a .pvd collection accumulating <DataSet timestep=.../> entries
  (src/paraview.h:157-198).

Per-element fields are written as nodal averages of the adjacent element
values (`elemental_to_nodal`), libMesh's nodal projection of CONSTANT
MONOMIAL variables.  Arrays come in as NumPy (the drivers move tensors
to the host first).  A MixedMesh's cells are its blocks' in block order,
each with its own VTK type; a TET10's last two mid-edge nodes are swapped
into VTK_QUADRATIC_TETRA's order, and a HEX20's or HEX27's nodes are
permuted from Gmsh's edge and face order into VTK's (QUAD8 and QUAD9 share
Gmsh's order).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..mesh.core import Mesh, element_blocks

SMALLEST_NUMBER = 1.0e-24

_VTK_TYPE = {"TET4": 10, "HEX8": 12, "TRI3": 5, "QUAD4": 9,
             "PRISM6": 13, "PYRAMID5": 14, "TET10": 24,
             # VTK_QUADRATIC_QUAD, VTK_BIQUADRATIC_QUAD,
             # VTK_QUADRATIC_HEXAHEDRON, VTK_TRIQUADRATIC_HEXAHEDRON
             "QUAD8": 23, "QUAD9": 28, "HEX20": 25, "HEX27": 29}
# VTK_QUADRATIC_TETRA orders the mid-edge nodes (0,1),(1,2),(0,2),(0,3),
# (1,3),(2,3); Gmsh swaps the last two
_TET10_TO_VTK = [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]
# Gmsh -> VTK node order of the quadratic hexes, by matching each edge's
# (node pair's) and face's (corner set's) role: Gmsh's hexahedron edges
# and faces, VTK's edges of vtkQuadraticHexahedron (bottom ring, top
# ring, verticals) and faces of vtkHexahedron::GetFace
_GMSH_HEX_EDGES = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
                   (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]
_VTK_HEX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6),
                  (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
_GMSH_HEX_FACES = [(0, 3, 2, 1), (0, 1, 5, 4), (0, 4, 7, 3),
                   (1, 2, 6, 5), (2, 3, 7, 6), (4, 5, 6, 7)]
_VTK_HEX_FACES = [(0, 4, 7, 3), (1, 2, 6, 5), (0, 1, 5, 4),
                  (3, 7, 6, 2), (0, 3, 2, 1), (4, 5, 6, 7)]


def _hex_perm(n27: bool):
    """Column permutation taking a Gmsh-ordered HEX20/27 row to VTK's."""
    ge = {frozenset(e): 8 + i for i, e in enumerate(_GMSH_HEX_EDGES)}
    perm = list(range(8)) + [ge[frozenset(e)] for e in _VTK_HEX_EDGES]
    if n27:
        gf = {frozenset(f): 20 + i for i, f in enumerate(_GMSH_HEX_FACES)}
        perm += [gf[frozenset(f)] for f in _VTK_HEX_FACES]
        perm.append(26)
    return perm


def elemental_to_nodal(mesh, values: np.ndarray) -> np.ndarray:
    """Arithmetic average of the adjacent element values at each node
    (values in the global element order: a MixedMesh's block by block)."""
    values = np.asarray(values)
    total = np.zeros(mesh.n_nodes)
    count = np.zeros(mesh.n_nodes)
    off = 0
    for _, conn in element_blocks(mesh):
        v = values[off:off + len(conn)]
        np.add.at(total, conn.ravel(), np.repeat(v, conn.shape[1]))
        np.add.at(count, conn.ravel(), 1.0)
        off += len(conn)
    return total / np.maximum(count, 1.0)


def _cell_arrays(mesh) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(flat connectivity, offsets, VTK types) of the cells in the global
    element order."""
    conns, sizes, types = [], [], []
    for elem_type, conn in element_blocks(mesh):
        if elem_type == "TET10":
            conn = conn[:, _TET10_TO_VTK]
        elif elem_type in ("HEX20", "HEX27"):
            conn = conn[:, _hex_perm(elem_type == "HEX27")]
        conns.append(conn.ravel())
        sizes.append(np.full(len(conn), conn.shape[1]))
        types.append(np.full(len(conn), _VTK_TYPE[elem_type]))
    return (np.concatenate(conns), np.cumsum(np.concatenate(sizes)),
            np.concatenate(types))


def _floats(vals) -> str:
    return " " + " ".join(map("{:g}".format, np.asarray(vals).tolist()))


def _ints(vals) -> str:
    return " " + " ".join(map(str, np.asarray(vals, dtype=np.int64)
                              .tolist()))


def _array(w, type_: str, name: str, body: str) -> None:
    w(f'        <DataArray type="{type_}" Name="{name}" '
      'NumberOfComponents="1" format="ascii">\n')
    w(body)
    w("\n        </DataArray>\n")


def write_vtu(
    path: str,
    mesh: Mesh,
    point_fields: Sequence[Tuple[str, np.ndarray]],
    cell_fields: Sequence[Tuple[str, np.ndarray]] = (),
    coords: Optional[np.ndarray] = None,
    processor_id: Optional[np.ndarray] = None,
) -> None:
    """Write one ASCII .vtu frame.

    point_fields: (name, (N,) array) in output order (project per-element
    fields with `elemental_to_nodal` first); cell_fields: extra
    (name, (E,) array) CellData after element_ID/region_ID/processor_ID;
    coords: the Points (default: the mesh's coordinates)."""
    coords = mesh.coords if coords is None else np.asarray(coords)
    E, N = mesh.n_elems, mesh.n_nodes
    cells, offsets, types = _cell_arrays(mesh)
    proc = processor_id if processor_id is not None else np.zeros(E, dtype=int)

    with open(path, "w") as f:
        w = f.write
        w('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
        w("  <UnstructuredGrid>\n")
        w(f'    <Piece  NumberOfPoints="{N}" NumberOfCells="{E}">\n')
        w("      <Points>\n")
        w('        <DataArray type="Float64" Name="position" NumberOfComponents="3" format="ascii">\n')
        w(_floats(coords.ravel()))
        w("\n        </DataArray>\n      </Points>\n")
        w("      <PointData>\n")
        _array(w, "Int32", "node_ID", _ints(np.arange(1, N + 1)))
        for name, vals in point_fields:
            vals = np.asarray(vals, dtype=np.float64)
            flushed = np.where(np.abs(vals) <= SMALLEST_NUMBER, 0.0, vals)
            _array(w, "Float64", name, _floats(flushed))
        w("      </PointData>\n")
        w("      <CellData>\n")
        for name, vals in (("element_ID", np.arange(1, E + 1)),
                           ("region_ID", mesh.subdomain_id),
                           ("processor_ID", proc)):
            _array(w, "Int32", name, _ints(vals))
        for name, vals in cell_fields:
            _array(w, "Float64", name,
                   _floats(np.asarray(vals, dtype=np.float64)))
        w("      </CellData>\n")
        w("      <Cells>\n")
        _array(w, "Int32", "connectivity", _ints(cells))
        _array(w, "Int32", "offsets", _ints(offsets))
        _array(w, "Int32", "types", _ints(types))
        w("      </Cells>\n    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


class ParaviewWriter:
    """Time-series writer: open_pvd / update_pvd / close_pvd
    (src/paraview.h:157-198)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._pvd = None
        self._base = None

    def open_pvd(self, base: str, resume: bool = False) -> None:
        """resume=True keeps the DataSet entries of an existing .pvd (a
        resumed run in the same results directory must not drop the time
        points written before it)."""
        if self._pvd is not None:
            raise RuntimeError("pvd already open")
        self._base = base
        prior = []
        if resume and os.path.exists(base + ".pvd"):
            with open(base + ".pvd") as f:
                prior = [ln for ln in f if "<DataSet" in ln]
        self._pvd = open(base + ".pvd", "w")
        self._pvd.write(
            '<?xml version="1.0"?>\n'
            '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">\n'
            "  <Collection>\n"
        )
        for ln in prior:
            self._pvd.write(ln)
        self._pvd.flush()

    def update_pvd(self, point_fields, t: int = 0, cell_fields=(),
                   coords: Optional[np.ndarray] = None,
                   processor_id: Optional[np.ndarray] = None) -> str:
        """Write frame `t` as <base>-<t>.vtu and add it to the .pvd."""
        if self._pvd is None:
            raise RuntimeError("open_pvd first")
        vtu = f"{self._base}-{t}.vtu"
        write_vtu(vtu, self.mesh, point_fields, cell_fields, coords,
                  processor_id)
        fname = os.path.basename(vtu)
        self._pvd.write(
            f'    <DataSet timestep="{t}" group="" part="0" file="{fname}"/>\n'
        )
        self._pvd.flush()
        return vtu

    def close_pvd(self) -> None:
        if self._pvd is None:
            return
        self._pvd.write("  </Collection>\n</VTKFile>\n")
        self._pvd.close()
        self._pvd = None
