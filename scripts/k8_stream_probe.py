"""Time ways of streaming dphi through K8's HEX20 / HEX27 path, in turns.

At the shapes of chip_smoke.py phases 19a (f64) and 20a (f32): 13,824
elements of box_hex_mesh(24) raised to HEX20 and HEX27, their geometry's
dphi, 5 species of seeded values.  Each instance runs

  * `tile`:  the package's kernel (csrc/gather_interp_generic.cu: a block
             a tile of 32 elements and all q, its corners gathered once,
             dphi through a register ring);
  * the variants of scripts/k8_stream_probe.cu (VARIANTS): `ring` (dphi
             one q at a time through a two-stage shared-memory ring by
             cp.async, a warp a species), `tile P=small / mid / K` (the
             package's kernel at other ring depths), `thread ring` (its
             mapping with a per-thread shared-memory ring by cp.async);
  * `other`: with --other ROOT, the kernel library of another checkout of
             the repository (its own fem/_build.py builds it there), e.g. a
             parent commit unpacked with `git archive` under build/;

each checked against the plain version (f64 within 1e-13, f32 within 1e-5
of the largest value) and timed as chip_smoke.py times a kernel (median of
20 CUDA-event calls behind a device sleep), in the order other, tile,
the variants, then back again.  Prints a line per instance, the card's
name and power limit, and a JSON summary as the last line.  Needs a CUDA
device.

    python3 scripts/k8_stream_probe.py [--other build/parent]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from rdcfes_tpu_torch.fem import _build  # noqa: E402
from rdcfes_tpu_torch.fem import kernels as K  # noqa: E402
from rdcfes_tpu_torch.systems.transient import ElementBlock  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


# scripts/k8_stream_probe.cu's variants, by their index there
VARIANTS = {"ring": 0, "tile P=small": 1, "tile P=mid": 2, "tile P=K": 3,
            "thread ring": 4}


def _probe_library() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "libk8_stream_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.CSRC), "-o", str(out),
                    str(ROOT / "scripts" / "k8_stream_probe.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    for tag in ("f64", "f32"):
        fn = getattr(lib, f"probe_k8_{tag}")
        fn.argtypes = [_I] + [_P] * 6 + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
    return lib


def _other_library(root: Path) -> ctypes.CDLL:
    """The kernel library of the checkout at `root`, built by its own
    fem/_build.py in a process started there."""
    path = subprocess.run(
        [sys.executable, "-c", "from rdcfes_tpu_torch.fem import _build; "
         "print(_build.build().path)"], cwd=root, check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[-1]
    lib = ctypes.CDLL(path)
    for tag in ("f64", "f32"):
        fn = getattr(lib, f"rdc_gather_interp_generic_{tag}")
        fn.argtypes = _build.SIGNATURES[f"rdc_gather_interp_generic_{tag}"]
        fn.restype = ctypes.c_int
    return lib


def _case(elem_type: str, dt: torch.dtype, dev):
    mesh = cs._p19_mesh(elem_type)
    blk = ElementBlock(elem_type, mesh.connectivity, dev)
    g = blk.geometry(torch.as_tensor(mesh.coords, dtype=torch.float64,
                                     device=dev), dt)
    rng = np.random.default_rng(18)
    u = torch.as_tensor(rng.standard_normal((5, mesh.n_nodes)), dtype=dt,
                        device=dev)
    return (u, blk.conn_T, np.ascontiguousarray(blk.phi, np.float64),
            g.dphi.contiguous())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="root of another checkout whose kernel library "
                    "is timed beside this one's")
    args = ap.parse_args(argv)
    dev, card = cs.phase_device()
    probe = _probe_library()
    other = _other_library(args.other.resolve()) if args.other else None
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = []
    for dt, tag, tol in ((torch.float64, "f64", 1e-13),
                         (torch.float32, "f32", 1e-5)):
        for elem_type in ("HEX20", "HEX27"):
            u, conn_T, phi, dphi = _case(elem_type, dt, dev)
            V, N = u.shape
            Kc, E = conn_T.shape
            Q = phi.shape[0]
            ph_dev = torch.as_tensor(phi, dtype=dt, device=dev)
            u_qp = torch.empty((V, Q, E), dtype=dt, device=dev)
            gx = torch.empty((V, Q, 3, E), dtype=dt, device=dev)
            ptrs = lambda: (u.data_ptr(), conn_T.data_ptr())

            def call(fn, *pre):
                rc = fn(*ptrs(), *pre, dphi.data_ptr(), u_qp.data_ptr(),
                        gx.data_ptr(), V, N, Kc, Q, E, stream())
                if rc != 0:
                    raise RuntimeError(f"launch failed, cudaError {rc}")
                return u_qp, gx

            runs = {"tile": lambda: K.gather_interp_generic(u, conn_T, phi,
                                                            dphi)}
            fn = getattr(probe, f"probe_k8_{tag}")
            for name, i in VARIANTS.items():
                runs[name] = (lambda i=i: call(
                    lambda *a: fn(i, *a), ph_dev.data_ptr()))
            if other is not None:
                prev = getattr(other, f"rdc_gather_interp_generic_{tag}")
                runs["other"] = lambda: call(prev, phi.ctypes.data,
                                             ph_dev.data_ptr())
            ref = K.gather_interp_generic_plain(u, conn_T, phi, dphi)
            scale = max(float(r.abs().max()) for r in ref)
            n_bytes = cs.nbytes(u, conn_T, dphi, *ref)
            bound_ms = 1e3 * n_bytes / cs.PEAK_BYTES_PER_S
            for name, run in runs.items():
                out = run()
                torch.cuda.synchronize()
                err = max(float((o - r).abs().max())
                          for o, r in zip(out, ref)) / scale
                cs.require(err <= tol, f"{name} {elem_type} {tag}: "
                           f"relative error {err:.3e} > {tol}")
            order = ["other", "tile", *VARIANTS]
            times = {}
            for name in order + order[::-1]:
                if name in runs:
                    times.setdefault(name, []).append(cs.cuda_ms(runs[name]))
            row = {"type": elem_type, "dtype": tag, "E": E, "V": V,
                   "bound_ms": bound_ms, "ms": times}
            rows.append(row)
            cs.say("k8 probe", type=elem_type, dtype=tag, E=E,
                   bound_ms=f"{bound_ms:.4f}",
                   **{k.replace(" ", "_"): "/".join(f"{t:.4f}" for t in v)
                      for k, v in times.items()},
                   pct_of_bound="/".join(
                       f"{k}:{100.0 * bound_ms / min(v):.1f}"
                       for k, v in times.items()))
            del u, dphi, u_qp, gx, ref
            torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps({"k8_probe": rows, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
