"""The native meshkit runtime: its build and its ctypes bindings (the
parser, sparsity builder and RCB partitioner of rdcfes_tpu.native,
without the NumPy fallback).

`meshkit.cpp` is compiled at first use with the host g++:

    g++ -O2 -shared -fPIC -std=c++17 -o <lib> native/meshkit.cpp

into `build/rdcfes_tpu_torch/` at the repository root, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads the library already built.  A failed build raises RuntimeError
with the compiler's output.  Nothing here runs at import time.

`read_gmsh_native` gives the arrays of mesh/gmsh.py's NumPy parser for a
single-type TET4, HEX8, HEX20 or HEX27 Gmsh 2.x file, or a 2D one of
TRI3, QUAD4, QUAD8 or QUAD9 elements; `build_sparsity_native` those of
fem/assembly's NumPy sparsity builder.  `partition_rcb` splits elements
into shards by recursive coordinate bisection of their centroids, the
reference's C++ routine (no NumPy version: the reference's one splits
equal centroids in another order, so it is not the same partition).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("meshkit.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rdcfes_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # 0.0 when the library was already built


class _GmshMesh(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("coords", ctypes.POINTER(ctypes.c_double)),
        ("n_vol", ctypes.c_int64),
        ("vol_type", ctypes.c_int32),
        ("vol_conn", ctypes.POINTER(ctypes.c_int32)),
        ("vol_phys", ctypes.POINTER(ctypes.c_int32)),
        ("n_surf", ctypes.c_int64),
        ("surf_type", ctypes.c_int32),
        ("surf_conn", ctypes.POINTER(ctypes.c_int32)),
        ("surf_phys", ctypes.POINTER(ctypes.c_int32)),
    ]


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native meshkit runtime "
                           "cannot be built")
    return cxx


def build() -> BuildResult:
    """Compile meshkit.cpp into the shared library unless it exists."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libmeshkit_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return BuildResult(lib, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders all land one file
    return BuildResult(lib, seconds)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded meshkit library (built on first call), with argtypes."""
    lib = ctypes.CDLL(str(build().path))
    lib.meshkit_read_gmsh.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(_GmshMesh)]
    lib.meshkit_read_gmsh.restype = ctypes.c_int
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.meshkit_build_sparsity.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(i32p), ctypes.POINTER(i32p), i32p]
    lib.meshkit_build_sparsity.restype = ctypes.c_int64
    lib.meshkit_free.argtypes = [ctypes.c_void_p]
    lib.meshkit_free.restype = None
    lib.meshkit_partition_rcb.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
        i32p]
    lib.meshkit_partition_rcb.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here (the reference's
    available(), whose library is built ahead of time)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


_GMSH_VOL = {4: ("TET4", 4), 5: ("HEX8", 8), 17: ("HEX20", 20),
             12: ("HEX27", 27), 2: ("TRI3", 3), 3: ("QUAD4", 4),
             16: ("QUAD8", 8), 10: ("QUAD9", 9)}
# boundary rows: TRI3, QUAD4, QUAD8, QUAD9 faces, EDGE2, EDGE3 sides
_GMSH_SURF = {2: 3, 3: 4, 16: 8, 10: 9, 1: 2, 8: 3}


def read_gmsh_native(path: str):
    """Parse a Gmsh 2.x ASCII file into a Mesh; ValueError (with the
    parser's code) on a file it does not take: several volume or
    boundary types, PRISM6, PYRAMID5, TET10, a TRI6 2D file, unknown
    element codes, a truncated or corrupt file."""
    from ..mesh.core import Mesh
    from ..mesh.gmsh import _attach_boundary_ids

    lib = library()
    out = _GmshMesh()
    rc = lib.meshkit_read_gmsh(os.fsencode(path), ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"meshkit_read_gmsh({path}) failed with code {rc}")
    try:
        N = out.n_nodes
        coords = np.ctypeslib.as_array(out.coords, shape=(N, 3)).copy()
        name, k = _GMSH_VOL[out.vol_type]
        conn = np.ctypeslib.as_array(out.vol_conn,
                                     shape=(out.n_vol, k)).copy()
        phys = np.ctypeslib.as_array(out.vol_phys, shape=(out.n_vol,)).copy()
        mesh = Mesh(coords=coords, connectivity=conn, elem_type=name,
                    subdomain_id=phys)
        if out.n_surf:
            kf = _GMSH_SURF[out.surf_type]
            sconn = np.ctypeslib.as_array(out.surf_conn,
                                          shape=(out.n_surf, kf))
            sphys = np.ctypeslib.as_array(out.surf_phys,
                                          shape=(out.n_surf,))
            _attach_boundary_ids(mesh, sconn.tolist(), sphys.tolist())
        return mesh
    finally:
        for ptr in (out.coords, out.vol_conn, out.vol_phys, out.surf_conn,
                    out.surf_phys):
            if ptr:
                lib.meshkit_free(ptr)


def build_sparsity_native(connectivity: np.ndarray, n_nodes: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Node-pair block-CSR structure of connectivity (E, K): (rows (nnz,),
    cols (nnz,), slots (E, K, K), nnz), the pairs sorted by (row, col)."""
    lib = library()
    conn = np.ascontiguousarray(connectivity, dtype=np.int32)
    E, K = conn.shape
    i32p = ctypes.POINTER(ctypes.c_int32)
    slots = np.empty((E, K, K), dtype=np.int32)
    rows_p, cols_p = i32p(), i32p()
    nnz = lib.meshkit_build_sparsity(
        conn.ctypes.data_as(i32p), E, K, n_nodes, ctypes.byref(rows_p),
        ctypes.byref(cols_p), slots.ctypes.data_as(i32p))
    if nnz < 0:
        raise RuntimeError("meshkit_build_sparsity failed")
    try:
        rows = np.ctypeslib.as_array(rows_p, shape=(nnz,)).copy()
        cols = np.ctypeslib.as_array(cols_p, shape=(nnz,)).copy()
    finally:
        lib.meshkit_free(rows_p)
        lib.meshkit_free(cols_p)
    return rows, cols, slots, int(nnz)


def partition_rcb(centers: np.ndarray, n_parts: int) -> np.ndarray:
    """Element partition (E,) int32 in 0..n_parts-1 by recursive
    coordinate bisection of the centroids centers (E, 3): each level
    splits along the longest axis of the bounding box at the
    n_left / n_parts quantile."""
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    if centers.ndim != 2 or centers.shape[1] != 3:
        raise ValueError(f"centers: shape {centers.shape}, expected (E, 3)")
    if n_parts < 1:
        raise ValueError(f"n_parts = {n_parts}, expected >= 1")
    E = centers.shape[0]
    part = np.empty(E, dtype=np.int32)
    library().meshkit_partition_rcb(
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), E,
        int(n_parts), part.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return part
