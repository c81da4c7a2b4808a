#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (rdcfes_tpu_torch) of the PIHNA transient
step on one NVIDIA GPU, and check it.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 0,1,2  # device, build, kernel checks

Phases, one output line each (any failure raises, exit code != 0):
  0 device  the CUDA device (never the CPU) and nvidia-smi's name and
            power limit of the card
  1 build   compile csrc/*.cu with nvcc (sm_90a), seconds taken
  2 kernels each kernel against its plain PyTorch version on the bench
            mesh and initial state (f64 within 1e-13, f32 within 1e-5,
            relative to the largest plain value); median CUDA-event time
            of 20 calls for both
  3 oracle  3 mixed-precision steps on box_tet_mesh(4,4,4) against the
            independent NumPy/SuperLU transcription oracle/pihna_numpy.py,
            per-step relative L2 within 1e-8 (the BASELINE.json contract)
  4 paths   3 steps at bench size through the kernels and through the
            plain versions, per-step relative L2 within 1e-10
  5 slice   the bench workload (bench.py:46-125): PIHNA, 24,389 nodes x 5,
            131,712 TET4, dt 0.1, 120 steps of run_steps with
            precision="mixed", precond_refresh=20, rtol=3e-11, after one
            warm-up run; launch counts reset just before the timed run

Then one JSON line {"kernels": [...]}, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from rdcfes_tpu_torch.fem import _build
from rdcfes_tpu_torch.fem import kernels as K
from rdcfes_tpu_torch.fem.weakform import diffusion_presum
from rdcfes_tpu_torch.mesh import box_tet_mesh
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.utils.device import cuda_device

F32, F64 = torch.float32, torch.float64
CSRC = "rdcfes_tpu_torch/csrc/"
# variant -> (source, the TPU kernel it replaces)
KERNELS = {
    "gather_interp_affine_f64": (CSRC + "gather_interp_affine.cu",
                                 "rdcfes_tpu/fem/pallas_df64.py:334"),
    "rhs_affine_f64": (CSRC + "rhs_affine.cu",
                       "rdcfes_tpu/fem/pallas_df64.py:240"),
    "apply_affine_f32": (CSRC + "apply_affine.cu",
                         "rdcfes_tpu/fem/pallas_apply.py:150"),
    "apply_affine_f64": (CSRC + "apply_affine.cu",
                         "rdcfes_tpu/fem/pallas_perm.py:274"),
    "restrict_f32": (CSRC + "restrict.cu",
                     "rdcfes_tpu/fem/pallas_perm.py:203"),
    "restrict_f64": (CSRC + "restrict.cu",
                     "rdcfes_tpu/fem/pallas_perm.py:298"),
}
BENCH_STEPS = 120


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------
def bench_case():
    """The headline bench leg's mesh, deck and initial state."""
    n = 28
    mesh = box_tet_mesh(n, n, n, bounds=((0, 150.0), (0, 180.0), (0, 150.0)))
    Kk = 2.39e5
    params = default_params()
    params.update(
        dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
        cells_max_capacity_exponent=3.0, cytokines_max_capacity=1.0e-8,
        necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk, necrosis_v=300.0 / Kk,
        produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82, switch_h2n=0.5,
        diffuse_v=0.5, produce_v=10.0,
        secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, decay_a=5678.4,
    )
    params = {k: float(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    u0 = np.zeros((mesh.n_nodes, 5))
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0[:, 1] = 2000.0 * np.exp(-r2 / (2 * 25.0**2))
    u0[:, 2] = 500.0 * np.exp(-r2 / (2 * 30.0**2))
    u0[:, 3] = 7200.0 * (1.0 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    return mesh, params, u0


def oracle_case():
    """The oracle parity case (tests/test_parity_oracle.py): every PIHNA
    term active on a small brain-like box."""
    mesh = box_tet_mesh(4, 4, 4, bounds=((0, 20.0), (0, 20.0), (0, 20.0)))
    Kk = 2.39e5
    p = default_params()
    p.update(
        dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
        cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
        necrosis_c=500 / Kk, necrosis_h=200 / Kk, necrosis_v=300 / Kk,
        produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82, switch_h2n=0.5,
        diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0, taxis_h=4e-5,
        diffuse_v=0.2, taxis_v=1e-4, produce_v=10.0,
        secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, uptake_a_v=1e-3,
        decay_a=5678.4,
    )
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 0] = 50.0 * np.exp(-r2 / 20.0)
    u0[:, 1] = 2000.0 * np.exp(-r2 / 30.0)
    u0[:, 2] = 500.0 * np.exp(-r2 / 25.0)
    u0[:, 3] = 7200.0 * np.exp(-r2 / 200.0)
    u0[:, 4] = 1e-10 * np.exp(-r2 / 50.0)
    return mesh, p, u0


def make_system(mesh, dev, ops=K.KERNEL_OPS, precond_refresh=20):
    return TransientRDCSystem(mesh, 5, pihna_blocks, rtol=3e-11,
                              precision="mixed",
                              precond_refresh=precond_refresh, device=dev,
                              ops=ops)


def rel_l2(a: torch.Tensor, b) -> float:
    a = a.detach().cpu().numpy()
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device():
    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("0 device", device=dev, kind=repr(torch.cuda.get_device_name(dev)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return dev


def phase_build():
    res = _build.build()
    _build.library()
    regs = [ln.strip() for ln in res.log.splitlines()
            if "registers" in ln or "spill" in ln]
    say("1 build", seconds=f"{res.seconds:.3f}", lib=res.path.name,
        ptxas_lines=len(regs))
    for ln in regs:
        print("    ptxas: " + ln, flush=True)


def cuda_ms(fn, runs: int = 20) -> float:
    """Median device time of one call, CUDA events.  Each call is queued
    behind a device sleep so the host's launch cost stays off the clock
    as far as the sleep covers it."""
    fn()
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    return abs_err, abs_err / scale


def phase_kernels(dev):
    mesh, params, u0 = bench_case()
    s = make_system(mesh, dev)
    V = 5
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    u_qp, gx1 = K.gather_interp_affine_plain(u, s.conn_T, s.phi, s.dphi0)
    grad_qp = gx1[:, None].expand(V, u_qp.shape[1], 3, gx1.shape[-1])
    wfb = pihna_blocks(u_qp, grad_qp, {}, params)
    rhs = K.stack_rhs(wfb)
    st64 = K.stack_apply(wfb, diffusion_presum(wfb, s.JxW))
    wfb32 = wfb.cast(F32)
    st32 = K.stack_apply(wfb32, diffusion_presum(wfb32, s.JxW32))
    u32 = u.to(F32)
    flat64 = K.rhs_affine_plain(rhs, s.JxW, s.phi, s.dphi0).reshape(V, -1)
    flat32 = K.apply_affine_plain(u32, s.conn_T, s.phi, s.JxW32, s.dphi0_32,
                                  st32).reshape(V, -1)
    cases = {
        "gather_interp_affine_f64": (
            lambda: K.gather_interp_affine(u, s.conn_T, s.phi, s.dphi0),
            lambda: K.gather_interp_affine_plain(u, s.conn_T, s.phi,
                                                 s.dphi0), 1e-13),
        "rhs_affine_f64": (
            lambda: K.rhs_affine(rhs, s.JxW, s.phi, s.dphi0),
            lambda: K.rhs_affine_plain(rhs, s.JxW, s.phi, s.dphi0), 1e-13),
        "apply_affine_f32": (
            lambda: K.apply_affine(u32, s.conn_T, s.phi, s.JxW32,
                                   s.dphi0_32, st32),
            lambda: K.apply_affine_plain(u32, s.conn_T, s.phi, s.JxW32,
                                         s.dphi0_32, st32), 1e-5),
        "apply_affine_f64": (
            lambda: K.apply_affine(u, s.conn_T, s.phi, s.JxW, s.dphi0, st64),
            lambda: K.apply_affine_plain(u, s.conn_T, s.phi, s.JxW, s.dphi0,
                                         st64), 1e-13),
        "restrict_f32": (
            lambda: K.restrict(flat32, s.node_gather),
            lambda: K.restrict_plain(flat32, s.node_gather), 1e-5),
        "restrict_f64": (
            lambda: K.restrict(flat64, s.node_gather),
            lambda: K.restrict_plain(flat64, s.node_gather), 1e-13),
    }
    results = {}
    for name, (kern, plain, tol) in cases.items():
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        abs_err, rel = _err(out, ref)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        say("2 kernel", name=name, max_abs_err=f"{abs_err:.3e}",
            rel_err=f"{rel:.3e}", tol=tol, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}")
        require(rel <= tol, f"{name}: relative error {rel:.3e} > {tol}")
        results[name] = {"max_abs_err": abs_err, "ms": ms,
                         "plain_ms": plain_ms}
    say("2 kernels", shapes=f"V=5 K=4 Q=5 E={mesh.n_elems} N={mesh.n_nodes} "
        f"C={s.node_gather.shape[0]}", live=f"C:{len(st64.idxC)} "
        f"D:{len(st64.idxD)} E:{len(st64.idxE)} A:{len(rhs.idxA)} "
        f"B:{len(rhs.idxB)}")
    return results


def phase_oracle(dev):
    from oracle.pihna_numpy import PihnaOracle

    mesh, p, u0 = oracle_case()
    orc = PihnaOracle(mesh.coords, mesh.connectivity, p)
    s = make_system(mesh, dev, precond_refresh=1)
    st = s.initial_state(u0)
    uo = u0.copy()
    worst = 0.0
    for _ in range(3):
        st, _, _ = s.step(st, params=p)
        uo, _ = orc.step(uo)
        worst = max(worst, rel_l2(st["u"], uo))
    say("3 oracle", steps=3, worst_rel_l2=f"{worst:.3e}", bar=1e-8)
    require(np.isfinite(uo).all() and worst < 1e-8,
            f"oracle parity violated: worst rel L2 {worst:.3e}")


def phase_paths(dev):
    mesh, params, u0 = bench_case()
    a = make_system(mesh, dev)
    b = make_system(mesh, dev, ops=K.PLAIN_OPS)
    sa, sb = a.initial_state(u0), b.initial_state(u0)
    worst = 0.0
    for _ in range(3):
        sa, _, _ = a.step(sa, params=params)
        sb, _, _ = b.step(sb, params=params)
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
    say("4 paths", steps=3, worst_rel_l2=f"{worst:.3e}", bar=1e-10)
    require(worst < 1e-10, f"kernel vs plain path: {worst:.3e}")


def phase_slice(dev):
    mesh, params, u0 = bench_case()
    s = make_system(mesh, dev)
    st, _, _ = s.run_steps(s.initial_state(u0), BENCH_STEPS, params=params)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    st, its, ress = s.run_steps(s.initial_state(u0), BENCH_STEPS,
                                params=params)
    u = st["u"].cpu().numpy()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    final_res = float(ress[-1])
    say("5 slice", steps=BENCH_STEPS, seconds=f"{wall:.4f}",
        steps_per_s=f"{BENCH_STEPS / wall:.4f}",
        inner_iters_total=int(its.sum()), final_residual=f"{final_res:.3e}",
        max_residual=f"{float(ress.max()):.3e}", n_nodes=mesh.n_nodes,
        n_elems=mesh.n_elems)
    say("5 launches", **counts)
    require(np.isfinite(u).all(), "non-finite state")
    require((u >= 0).all(), "negative state after the clamp")
    require(final_res <= 3e-11, f"final residual {final_res:.3e} > 3e-11")
    missing = [k for k, n in counts.items() if n == 0]
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5",
                    help="comma-separated phases to run (default: all)")
    phases = {int(x) for x in ap.parse_args(argv).phases.split(",")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    if 1 in phases:
        phase_build()
    kern = phase_kernels(dev) if 2 in phases else {}
    if 3 in phases:
        phase_oracle(dev)
    if 4 in phases:
        phase_paths(dev)
    counts = phase_slice(dev) if 5 in phases else {}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces}
        if name in counts:
            row["launches"] = counts[name]
        row.update(kern.get(name, {}))
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
