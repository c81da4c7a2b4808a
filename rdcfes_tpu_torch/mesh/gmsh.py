"""Gmsh 2.x ASCII mesh reader and writer for single-type 3D meshes (TET4,
HEX8, TET10, HEX20, HEX27), 2D meshes (TRI3, QUAD4, QUAD8, QUAD9) and
mixed meshes of TET4, HEX8, PRISM6 and PYRAMID5 (the NumPy parser of
rdcfes_tpu.mesh.gmsh: the same arrays from a file, the same bytes
written).

Format as the C++ reference's writer gives it (src/process_mesh.C:22-83):
`$MeshFormat 2.2 0 8`, 1-based node ids, two integer tags per element
(physical id, 0), boundary side elements (TRI3 / QUAD4, physical tag =
boundary-condition id; EDGE2 / EDGE3 on a 2D mesh, QUAD8 / QUAD9 on
HEX20 / HEX27) before the volume elements (physical tag = subdomain id).  Node and element ids are compacted to 0-based indices in
FILE ORDER: the initial-condition files are read in that order
(src/pihna.C:287-310).

A file path goes through the native meshkit parser (native/, built with
the host C++ compiler at first use), as the reference's does
(rdcfes_tpu/mesh/gmsh.py:66-83); a file it does not take (several volume
types, TET10, a 2D file it cannot classify), and a text stream, go
through the NumPy parser below, the plain version, which gives the same
arrays.

3D volume elements of one type make a Mesh; several types make a
MixedMesh, one MeshBlock per type in first-seen order, its boundary ids
from the TRI3 and QUAD4 rows.  A file without 3D volume elements is a 2D
mesh: its TRI3, QUAD4, QUAD8 or QUAD9 rows are the volume elements (one
type, else ValueError; TRI6 rows raise ValueError) and its EDGE2 / EDGE3
rows carry the boundary ids, as the reference classifies them
(rdcfes_tpu/mesh/gmsh.py:151-190).
"""

from __future__ import annotations

import io
from typing import Dict, TextIO, Union

import numpy as np

from .core import Mesh, MeshBlock, MixedMesh

# Gmsh element type codes
_VOLUME = {4: ("TET4", 4), 5: ("HEX8", 8), 6: ("PRISM6", 6),
           7: ("PYRAMID5", 5), 11: ("TET10", 10), 17: ("HEX20", 20),
           12: ("HEX27", 27)}
# boundary rows of a 3D mesh, the volume rows of a 2D one: TRI3, QUAD4,
# TRI6, QUAD8, QUAD9
_SURFACE = {2: 3, 3: 4, 9: 6, 16: 8, 10: 9}
_EDGE = {1: 2, 8: 3}  # EDGE2, EDGE3: the boundary rows of a 2D mesh
_2D = {3: "TRI3", 4: "QUAD4", 8: "QUAD8", 9: "QUAD9"}  # by node count
# a file of one of these is a Mesh
_SINGLE = ("TET4", "HEX8", "TET10", "HEX20", "HEX27")
_CODE = {name: code for code, (name, _) in _VOLUME.items()}
_CODE.update({"TRI3": 2, "QUAD4": 3, "QUAD8": 16, "QUAD9": 10})
_FACE_CODE = {"TET4": 2, "HEX8": 3, "TET10": 9, "HEX20": 16, "HEX27": 10,
              "TRI3": 1, "QUAD4": 1, "QUAD8": 8, "QUAD9": 8}


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
    by_type: Dict[str, list] = {}  # type -> [(nodes, physical)]
    surf_conn, surf_bcid = [], []
    edge_conn, edge_bcid = [], []
    for _ in range(n_elems_total):
        parts = next(lines).split()
        etype = int(parts[1])
        ntags = int(parts[2])
        tags = [int(t) for t in parts[3:3 + ntags]]
        nodes = [id_map[int(g)] for g in parts[3 + ntags:]]
        physical = tags[0] if tags else 0
        if etype in _VOLUME:
            name, k = _VOLUME[etype]
            if len(nodes) != k:
                raise ValueError(f"{name} element with {len(nodes)} nodes")
            if name not in kinds:
                kinds.append(name)
                by_type[name] = []
            by_type[name].append((nodes, physical))
        elif etype in _SURFACE:
            if len(nodes) != _SURFACE[etype]:
                raise ValueError(f"surface element type {etype} with "
                                 f"{len(nodes)} nodes")
            surf_conn.append(nodes)
            surf_bcid.append(physical)
        elif etype in _EDGE:
            # the boundary of a 2D mesh (unused when the file has 3D
            # volume elements)
            edge_conn.append(nodes)
            edge_bcid.append(physical)
        # points carry nothing a mesh uses
    if not kinds:
        return _mesh_2d(coords, surf_conn, surf_bcid, edge_conn, edge_bcid)
    arrays = lambda name: (
        np.asarray([r[0] for r in by_type[name]], dtype=np.int32),
        np.asarray([r[1] for r in by_type[name]], dtype=np.int32))
    if len(kinds) == 1 and kinds[0] in _SINGLE:
        conn, sid = arrays(kinds[0])
        mesh = Mesh(coords=coords, connectivity=conn, elem_type=kinds[0],
                    subdomain_id=sid)
        if surf_conn:
            _attach_boundary_ids(mesh, surf_conn, surf_bcid)
        return mesh
    mesh = MixedMesh(coords=coords, blocks=[MeshBlock(name, *arrays(name))
                                            for name in kinds])
    if surf_conn:
        _attach_boundary_ids_mixed(mesh, surf_conn, surf_bcid)
    return mesh


def _mesh_2d(coords, surf_conn, surf_bcid, edge_conn, edge_bcid) -> Mesh:
    """A file without 3D volume elements: its TRI3, QUAD4, QUAD8 or QUAD9
    rows are the volume elements (their physical tags the subdomain ids)
    and its EDGE2 / EDGE3 rows the boundary, with the reference's errors
    (rdcfes_tpu/mesh/gmsh.py:151-177)."""
    bad = sorted({len(f) for f in surf_conn} - set(_2D))
    if bad:
        raise ValueError(
            f"unsupported 2D volume element ({bad[0]}-node surface row; "
            "TRI3/QUAD4/QUAD8/QUAD9 2D meshes are supported)")
    kinds = sorted({_2D[len(f)] for f in surf_conn})
    if not kinds:
        raise ValueError("mesh contains no supported volume elements")
    if len(kinds) > 1:
        raise ValueError("mixed-type 2D meshes are not supported")
    mesh = Mesh(coords=coords,
                connectivity=np.asarray(surf_conn, dtype=np.int32),
                elem_type=kinds[0],
                subdomain_id=np.asarray(surf_bcid, dtype=np.int32))
    if edge_conn:
        _attach_boundary_ids(mesh, edge_conn, edge_bcid)
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


def _attach_boundary_ids_mixed(mesh: MixedMesh, surf_faces,
                               surf_ids) -> None:
    """_attach_boundary_ids for a MixedMesh, whose boundary faces are
    padded with -1 to 4 nodes."""
    key_of = {tuple(sorted(f)): i
              for i, f in enumerate(mesh.boundary_faces.tolist())}
    for f, bid in zip(surf_faces, surf_ids):
        key = sorted(f)
        if len(key) == 3:
            key = [-1] + key
        i = key_of.get(tuple(key))
        if i is not None:
            mesh.boundary_id[i] = bid


def write(mesh, path_or_file: Union[str, TextIO]) -> None:
    """Write Gmsh 2.2 ASCII: boundary faces first (physical tag = boundary
    id), then the volume elements (physical tag = subdomain id), a
    MixedMesh's block by block."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as out:
            _write(mesh, out)
    else:
        _write(mesh, path_or_file)


def _write(mesh, out: TextIO) -> None:
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
    mixed = mesh.elem_type == "MIXED"
    if n_faces:
        for f, bid in zip(faces.tolist(), mesh.boundary_id.tolist()):
            if mixed:
                f = [n for n in f if n >= 0]
                code = 2 if len(f) == 3 else 3
            else:
                code = _FACE_CODE[mesh.elem_type]
            nodes = " ".join(str(n + 1) for n in f)
            w(f"{index} {code} 2 {bid} 0 {nodes}\n")
            index += 1
    blocks = (mesh.blocks if mixed else [mesh])
    for b in blocks:
        code = _CODE[b.elem_type]
        for conn, sid in zip(b.connectivity.tolist(),
                             b.subdomain_id.tolist()):
            nodes = " ".join(str(n + 1) for n in conn)
            w(f"{index} {code} 2 {sid} 0 {nodes}\n")
            index += 1
    w("$EndElements\n")


def dumps(mesh: Mesh) -> str:
    buf = io.StringIO()
    write(mesh, buf)
    return buf.getvalue()
