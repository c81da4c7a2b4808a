"""Build and load the CUDA kernels of `csrc/` (Hopper, sm_90a).

The sources are compiled at first use with nvcc into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/*.cu

The library goes to `build/rdcfes_tpu_torch/` at the repository root,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the library already built.  Nothing here runs at
import time.
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
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rdcfes_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu: pointers (device, host tables, stream) as
# c_void_p so 64-bit addresses are never cut; each returns a cudaError_t.
SIGNATURES = {
    "rdc_gather_interp_affine_f64": [_P] * 6 + [_I] * 5 + [_P],
    "rdc_rhs_affine_f64": [_P] * 7 + [_I] * 4 + [_P],
    "rdc_apply_affine_f32": [_P] * 10 + [_I] * 5 + [_P],
    "rdc_apply_affine_f64": [_P] * 10 + [_I] * 5 + [_P],
    "rdc_restrict_f32": [_P] * 3 + [_I] * 4 + [_P],
    "rdc_restrict_f64": [_P] * 3 + [_I] * 4 + [_P],
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register/spill report)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build() -> BuildResult:
    """Compile csrc/*.cu into the shared library unless it exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"librdcfes_kernels_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return BuildResult(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
