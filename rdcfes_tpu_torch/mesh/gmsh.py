"""Gmsh 2.x ASCII mesh reader and writer for single-type TET4 and HEX8
meshes (the NumPy parser of rdcfes_tpu.mesh.gmsh: the same arrays from a
file, the same bytes written).

Format as the C++ reference's writer gives it (src/process_mesh.C:22-83):
`$MeshFormat 2.2 0 8`, 1-based node ids, two integer tags per element
(physical id, 0), boundary side elements (TRI3 / QUAD4, physical tag =
boundary-condition id) before the volume elements (physical tag =
subdomain id).  Node and element ids are compacted to 0-based indices in
FILE ORDER: the initial-condition files are read in that order
(src/pihna.C:287-310).

A file path goes through the native meshkit parser (native/, built with
the host C++ compiler at first use), as the reference's does
(rdcfes_tpu/mesh/gmsh.py:66-83); a file it does not take, and a text
stream, go through the NumPy parser below, the plain version, which gives
the same arrays.

A file whose volume elements are of more than one type, or of a type
other than TET4 and HEX8 (TET10, PRISM6, PYRAMID5, the hexes of order 2,
a 2D mesh), raises NotImplementedError: ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import io
from typing import Dict, TextIO, Union

import numpy as np

from .core import Mesh

_ITEM13 = "ROADMAP queue 1 item 13 (mixed meshes and element types " \
          "beyond TET4 and HEX8)"
# Gmsh element type codes
_VOLUME = {4: ("TET4", 4), 5: ("HEX8", 8)}
_OTHER_VOLUME = {6: "PRISM6", 7: "PYRAMID5", 11: "TET10", 12: "HEX27",
                 17: "HEX20"}
_SURFACE = {2: 3, 3: 4}  # boundary rows: TRI3, QUAD4
_CODE = {"TET4": 4, "HEX8": 5}
_FACE_CODE = {"TET4": 2, "HEX8": 3}


def read(path_or_file: Union[str, TextIO]) -> Mesh:
    """Read a Gmsh 2.x ASCII mesh (a path or a text stream) into a Mesh:
    a path whose header is Gmsh 2.x through the native parser, anything
    else, or a file the native parser refuses, through `read_numpy`."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "r") as f:
            head = f.read(64)
        if "$MeshFormat\n2" in head:
            from ..native import read_gmsh_native

            try:
                return read_gmsh_native(path_or_file)
            except ValueError:
                pass  # the NumPy parser reads it, or says what is wrong
    return read_numpy(path_or_file)


def read_numpy(path_or_file: Union[str, TextIO]) -> Mesh:
    """The NumPy parser: a Gmsh 2.x ASCII mesh (a path or a text stream)
    into a Mesh."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "r") as f:
            text = f.read()
    else:
        text = path_or_file.read()
    try:
        return _read_lines(iter(text.splitlines()))
    except StopIteration:
        raise ValueError("truncated Gmsh file") from None


def _read_lines(lines) -> Mesh:

    def seek(section: str) -> bool:
        for line in lines:
            if line.strip() == section:
                return True
        return False

    if not seek("$MeshFormat"):
        raise ValueError("not a Gmsh file: missing $MeshFormat")
    fmt = next(lines).split()
    if not fmt[0].startswith("2"):
        raise ValueError(f"only Gmsh 2.x ASCII supported, got version {fmt[0]}")

    if not seek("$Nodes"):
        raise ValueError("missing $Nodes")
    n_nodes = int(next(lines))
    node_ids = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3), dtype=np.float64)
    for i in range(n_nodes):
        parts = next(lines).split()
        node_ids[i] = int(parts[0])
        coords[i] = [float(parts[1]), float(parts[2]), float(parts[3])]
    id_map: Dict[int, int] = {int(g): i for i, g in enumerate(node_ids)}

    if not seek("$Elements"):
        raise ValueError("missing $Elements")
    n_elems_total = int(next(lines))
    kinds = []  # volume element types in first-seen order
    vol_conn, vol_sid = [], []
    surf_conn, surf_bcid = [], []
    for _ in range(n_elems_total):
        parts = next(lines).split()
        etype = int(parts[1])
        ntags = int(parts[2])
        tags = [int(t) for t in parts[3:3 + ntags]]
        nodes = [id_map[int(g)] for g in parts[3 + ntags:]]
        physical = tags[0] if tags else 0
        if etype in _VOLUME or etype in _OTHER_VOLUME:
            name = _VOLUME[etype][0] if etype in _VOLUME \
                else _OTHER_VOLUME[etype]
            if name not in kinds:
                kinds.append(name)
            if etype in _VOLUME:
                if len(nodes) != _VOLUME[etype][1]:
                    raise ValueError(f"{name} element with {len(nodes)} "
                                     "nodes")
                vol_conn.append(nodes)
                vol_sid.append(physical)
        elif etype in _SURFACE:
            if len(nodes) != _SURFACE[etype]:
                raise ValueError(f"surface element type {etype} with "
                                 f"{len(nodes)} nodes")
            surf_conn.append(nodes)
            surf_bcid.append(physical)
        # points, edges and quadratic faces carry nothing a TET4 or HEX8
        # mesh uses
    if not kinds:
        raise NotImplementedError(
            f"mesh without 3D volume elements (a 2D mesh): {_ITEM13}")
    if len(kinds) > 1 or kinds[0] not in _CODE:
        raise NotImplementedError(
            f"volume element types {kinds}: {_ITEM13}")
    mesh = Mesh(coords=coords,
                connectivity=np.asarray(vol_conn, dtype=np.int32),
                elem_type=kinds[0],
                subdomain_id=np.asarray(vol_sid, dtype=np.int32))
    if surf_conn:
        _attach_boundary_ids(mesh, surf_conn, surf_bcid)
    return mesh


def _attach_boundary_ids(mesh: Mesh, surf_faces, surf_ids) -> None:
    """Boundary-condition ids of the file's surface elements onto the
    topologically extracted boundary faces (matched by sorted node key)."""
    key_of = {tuple(sorted(f)): i
              for i, f in enumerate(mesh.boundary_faces.tolist())}
    for f, bid in zip(surf_faces, surf_ids):
        i = key_of.get(tuple(sorted(f)))
        if i is not None:
            mesh.boundary_id[i] = bid


def write(mesh: Mesh, path_or_file: Union[str, TextIO]) -> None:
    """Write Gmsh 2.2 ASCII: boundary faces first (physical tag = boundary
    id), then the volume elements (physical tag = subdomain id)."""
    if mesh.elem_type not in _CODE:
        raise NotImplementedError(f"{mesh.elem_type} meshes: {_ITEM13}")
    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as out:
            _write(mesh, out)
    else:
        _write(mesh, path_or_file)


def _write(mesh: Mesh, out: TextIO) -> None:
    w = out.write
    w("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    w("$Nodes\n")
    w(f"{mesh.n_nodes}\n")
    for i, (x, y, z) in enumerate(mesh.coords.tolist()):
        w(f"{i + 1} {x:.6g} {y:.6g} {z:.6g}\n")
    w("$EndNodes\n")
    faces = mesh.boundary_faces
    n_faces = 0 if faces is None else len(faces)
    w("$Elements\n")
    w(f"{n_faces + mesh.n_elems}\n")
    index = 1
    code = _FACE_CODE[mesh.elem_type]
    if n_faces:
        for f, bid in zip(faces.tolist(), mesh.boundary_id.tolist()):
            nodes = " ".join(str(n + 1) for n in f)
            w(f"{index} {code} 2 {bid} 0 {nodes}\n")
            index += 1
    code = _CODE[mesh.elem_type]
    for conn, sid in zip(mesh.connectivity.tolist(),
                         mesh.subdomain_id.tolist()):
        nodes = " ".join(str(n + 1) for n in conn)
        w(f"{index} {code} 2 {sid} 0 {nodes}\n")
        index += 1
    w("$EndElements\n")


def dumps(mesh: Mesh) -> str:
    buf = io.StringIO()
    write(mesh, buf)
    return buf.getvalue()
