"""Build and load the CUDA kernels of `csrc/` (Hopper, sm_90a).

The sources are compiled at first use with nvcc, one process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<name>.cu   # each
    nvcc -shared -o <lib> <objs>

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu: pointers (device, host tables, plans, stream)
# as c_void_p so 64-bit addresses are never cut; each returns a
# cudaError_t.  K3, K4 and K6 launch from a plan (csrc/common.cuh) that
# their *_plan entry point writes once.
SIGNATURES = {
    "rdc_gather_interp_affine_f64": [_P] * 6 + [_I] * 5 + [_P],
    "rdc_gather_interp_affine_f32": [_P] * 6 + [_I] * 5 + [_P],
    "rdc_rhs_affine_f64": [_P] * 7 + [_I] * 4 + [_P],
    "rdc_rhs_affine_f32": [_P] * 7 + [_I] * 4 + [_P],
    "rdc_apply_affine_plan": [_P, _I] + [_P] * 8 + [_I] * 7,
    "rdc_apply_affine_f32": [_P] * 4,
    "rdc_apply_affine_f64": [_P] * 4,
    "rdc_restrict_plan": [_P, _I, _P] + [_I] * 3,
    "rdc_restrict_f32": [_P] * 3 + [_I] * 2 + [_P],
    "rdc_restrict_f64": [_P] * 3 + [_I] * 2 + [_P],
    "rdc_ell_matvec_f32": [_P] * 4 + [_I] * 4 + [_P],
    "rdc_ell_matvec_f64": [_P] * 4 + [_I] * 4 + [_P],
    "rdc_apply_generic_plan": [_P, _I] + [_P] * 9 + [_I] * 10,
    "rdc_apply_generic_f32": [_P] * 4,
    "rdc_apply_generic_f64": [_P] * 4,
    "rdc_take_along_f32": [_P] * 3 + [_I] * 3 + [_P],
    "rdc_gather_interp_generic_f64": [_P] * 7 + [_I] * 5 + [_P],
    "rdc_gather_interp_generic_f32": [_P] * 7 + [_I] * 5 + [_P],
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register/spill report), kept
                     # beside the library for a later load


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
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return BuildResult(lib, 0.0, log_path.read_text()
                           if log_path.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name}: exit {proc.returncode}")
    objs = [obj for obj, _ in jobs]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    if not failed:
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link: exit {proc.returncode}")
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({'; '.join(failed)}):\n{log}")
    log_path.write_text(log)
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
