"""ParaView VTU / PVD writers for single-type TET4 and HEX8 meshes (the
files of rdcfes_tpu.io.vtu, byte for byte).

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
to the host first).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..mesh.core import Mesh

SMALLEST_NUMBER = 1.0e-24

_VTK_TYPE = {"TET4": 10, "HEX8": 12}


def elemental_to_nodal(mesh: Mesh, values: np.ndarray) -> np.ndarray:
    """Arithmetic average of the adjacent element values at each node."""
    values = np.asarray(values)
    total = np.zeros(mesh.n_nodes)
    count = np.zeros(mesh.n_nodes)
    conn = mesh.connectivity
    np.add.at(total, conn.ravel(), np.repeat(values, conn.shape[1]))
    np.add.at(count, conn.ravel(), 1.0)
    return total / np.maximum(count, 1.0)


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
    if mesh.elem_type not in _VTK_TYPE:
        raise NotImplementedError(
            f"{mesh.elem_type} meshes: ROADMAP queue 1 item 13")
    coords = mesh.coords if coords is None else np.asarray(coords)
    E, N, K = mesh.n_elems, mesh.n_nodes, mesh.nodes_per_elem
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
        _array(w, "Int32", "connectivity", _ints(mesh.connectivity.ravel()))
        _array(w, "Int32", "offsets", _ints(K * np.arange(1, E + 1)))
        _array(w, "Int32", "types", _ints(np.full(E, _VTK_TYPE[mesh.elem_type])))
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
