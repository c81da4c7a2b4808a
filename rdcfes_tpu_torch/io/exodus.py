"""Minimal ExodusII (.ex2) mesh writer for single-type TET4 and HEX8
meshes (the layout of rdcfes_tpu.io.exodus).

Covers the C++ reference's ExodusII export (`ExodusII_IO(msh).write`,
src/process_mesh.C:169): an unstructured mesh as one element block (the
reference package's optional nodal variables have no caller here).
ExodusII is NetCDF-3 classic underneath; the standard dimensions and
variables go through `scipy.io.netcdf_file` (no libnetcdf or exodus
library), readable by ParaView or any NetCDF tool.  A MIXED mesh (one
block per element type) and a TET10 mesh raise NotImplementedError:
ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh

_ITEM13 = "ROADMAP queue 1 item 13 (ExodusII multi-block export: MIXED " \
          "and TET10 meshes)"
_ELEM_TYPE_NAME = {"TET4": "TETRA4", "HEX8": "HEX8"}


def write_exodus(path: str, mesh: Mesh) -> None:
    """Write `mesh` to the ExodusII file `path`."""
    etype = getattr(mesh, "elem_type", None)
    if etype not in _ELEM_TYPE_NAME:
        raise NotImplementedError(f"ExodusII export of {etype} meshes: "
                                  f"{_ITEM13}")
    from scipy.io import netcdf_file

    conn = mesh.connectivity
    f = netcdf_file(path, "w", version=1)
    try:
        f.title = b"rdcfes_tpu_torch export"
        f.api_version = np.float32(5.22)
        f.version = np.float32(5.22)
        f.floating_point_word_size = np.int32(8)
        f.file_size = np.int32(1)

        # the unlimited dimension must come first in scipy
        f.createDimension("time_step", None)
        f.createDimension("len_string", 33)
        f.createDimension("len_line", 81)
        f.createDimension("four", 4)
        f.createDimension("num_dim", 3)
        f.createDimension("num_nodes", mesh.n_nodes)
        f.createDimension("num_elem", mesh.n_elems)
        f.createDimension("num_el_blk", 1)
        f.createDimension("num_el_in_blk1", conn.shape[0])
        f.createDimension("num_nod_per_el1", conn.shape[1])

        eb_status = f.createVariable("eb_status", "i", ("num_el_blk",))
        eb_status[:] = np.ones(1, dtype=np.int32)
        eb_prop = f.createVariable("eb_prop1", "i", ("num_el_blk",))
        eb_prop[:] = np.ones(1, dtype=np.int32)
        eb_prop.name = b"ID"
        connect = f.createVariable("connect1", "i",
                                   ("num_el_in_blk1", "num_nod_per_el1"))
        connect[:] = (conn + 1).astype(np.int32)  # 1-based
        connect.elem_type = _ELEM_TYPE_NAME[etype].encode()

        coord = f.createVariable("coord", "d", ("num_dim", "num_nodes"))
        coord[:] = mesh.coords.T
        names = f.createVariable("coor_names", "c",
                                 ("num_dim", "len_string"))
        names[:] = np.zeros((3, 33), dtype="S1")
        for i, nm in enumerate((b"x", b"y", b"z")):
            names[i, 0] = nm
    finally:
        f.close()
