"""Minimal ExodusII (.ex2) mesh writer (the layout of
rdcfes_tpu.io.exodus).

Covers the C++ reference's ExodusII export (`ExodusII_IO(msh).write`,
src/process_mesh.C:169): an unstructured mesh as one element block per
type (TETRA4, HEX8, WEDGE6, PYRAMID5 or TETRA10; a MixedMesh writes one
block per entry of `mesh.blocks`).  The reference package's optional
nodal variables have no caller here.  ExodusII is NetCDF-3 classic
underneath; the standard dimensions and variables go through
`scipy.io.netcdf_file` (no libnetcdf or exodus library), readable by
ParaView or any NetCDF tool.
"""

from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh

_ELEM_TYPE_NAME = {"TET4": "TETRA4", "HEX8": "HEX8",
                   "PRISM6": "WEDGE6", "PYRAMID5": "PYRAMID5",
                   "TET10": "TETRA10"}


def write_exodus(path: str, mesh: Mesh) -> None:
    """Write `mesh` (a Mesh or a MixedMesh) to the ExodusII file `path`."""
    from scipy.io import netcdf_file

    if mesh.elem_type == "MIXED":
        blocks = [(b.elem_type, b.connectivity) for b in mesh.blocks]
    else:
        blocks = [(mesh.elem_type, mesh.connectivity)]
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
        f.createDimension("num_el_blk", len(blocks))
        for i, (_, conn) in enumerate(blocks, 1):
            f.createDimension(f"num_el_in_blk{i}", conn.shape[0])
            f.createDimension(f"num_nod_per_el{i}", conn.shape[1])

        eb_status = f.createVariable("eb_status", "i", ("num_el_blk",))
        eb_status[:] = np.ones(len(blocks), dtype=np.int32)
        eb_prop = f.createVariable("eb_prop1", "i", ("num_el_blk",))
        eb_prop[:] = np.arange(1, len(blocks) + 1, dtype=np.int32)
        eb_prop.name = b"ID"
        for i, (etype, conn) in enumerate(blocks, 1):
            connect = f.createVariable(
                f"connect{i}", "i",
                (f"num_el_in_blk{i}", f"num_nod_per_el{i}"))
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
