#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (rdcfes_tpu_torch) on one NVIDIA GPU, and
check it: the PIHNA transient step on TET4 (phases 2-5), the hyperelastic
solid load step (phases 6-8), the generic (HEX8) transient path with
PIHNA and ADPM plus the launch-cost calibration (phases 9-12), and the
CLI with its PIHNA, ADPM and solid drivers (phase 13).

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py --phases 0,1,2           # device, build, kernels
    python3 chip_smoke.py --phases 0,1,6,7,8       # the solid slice
    python3 chip_smoke.py --phases 0,1,9,10,11,12  # HEX8, ADPM, calibration
    python3 chip_smoke.py --phases 0,1,13          # the CLI drivers

Phases, one output line each (any failure raises, exit code != 0):
  0 device  the CUDA device (never the CPU) and nvidia-smi's name and
            power limit of the card
  1 build   compile csrc/*.cu with nvcc (sm_90a), one process per source,
            seconds taken
  2 kernels each transient kernel against its plain PyTorch version on
            the bench mesh and initial state (f64 within 1e-13, f32 within
            1e-5, relative to the largest plain value), K4 also at the
            block-Jacobi diagonal's width; median CUDA-event time of 20
            calls for the kernel, the plain version and, where one exists,
            one library call computing the same function
  3 oracle  3 mixed-precision steps on box_tet_mesh(4,4,4) against the
            independent NumPy/SuperLU transcription oracle/pihna_numpy.py,
            per-step relative L2 within 1e-8 (the BASELINE.json contract)
  4 paths   3 steps at bench size through the kernels and through the
            plain versions, per-step relative L2 within 1e-10
  5 slice   the bench workload (bench.py:46-125): PIHNA, 24,389 nodes x 5,
            131,712 TET4, dt 0.1, 120 steps of run_steps with
            precision="mixed", precond_refresh=20, rtol=3e-11, after one
            warm-up run; launch counts reset just before the timed run
  6 solid kernels  K5 (f32, f64) and K4's matrix assembly (f32, f64) at
            the solid bench's shapes, on the tangent assembled at
            perturbed positions, against their plain versions (f64 within
            1e-13, f32 within 1e-5), timed as in phase 2
  7 solid paths  one load step on box_hex_mesh(12,12,12) with exact-f64
            options through the kernels and through the plain versions,
            relative L2 of the displacements within 1e-10
  8 solid slice  the solid bench leg (bench.py:290-341): box_hex_mesh(48,
            48,48), 110,592 HEX8, f32 tangent, modified Newton,
            mixed-precision Krylov, run_solver(x0, 0.5) after one warm-up;
            launch counts reset just before the timed run; |R|/|R0| <= 1e-6
            re-checked on the plain f64 residual; then one run timed stage
            by stage and one under torch.profiler for the device's busy
            share

  9 generic kernels  every launch of the HEX8 and ADPM steps at its own
            shapes: K8, K6 (f32, f64) and K4 (f32 and f64 at W = V, f64 at
            W = V V) on box_hex_mesh(48,48,48) (110,592 HEX8) with the
            PIHNA bench deck's live blocks and again with ADPM's
            taxis-active blocks (V = 3, live D planes); K1-K4 on the ADPM
            legs' TET4 28^3 mesh with ADPM's blocks; and K7 at the
            calibration's shapes (table (192,128), indices (4608,128));
            K6 again on box_hex_mesh(5,5,5) (E = 125: odd, a ragged last
            tile); each against its plain version (f64 within 1e-13, f32
            within 1e-5; K7 exact), timed as in phase 2; index_add_ beside
            K4, torch.gather beside K7
  10 calibration  time = a + b n fitted from n = 8 and n = 40 back-to-back
            eager bodies with one synchronize at the end (the counterpart
            of scripts/microbench_calib.py): a scalar sqrt chain, a 67 MB
            and a 2.3 MB stream, a 2.3 MB transpose + sqrt, the
            restriction gather at the TET4 bench's shapes through K4, K7,
            and K6 f32 and K3 f32 with the PIHNA blocks on
            box_hex_mesh(12,12,12) and box_tet_mesh(12,12,12); a is the
            fixed cost, b the cost per body, beside the host's cost of
            issuing a body (the loop before the synchronize) and its
            CUDA-event time; then the host time of each piece of a launch
            (allocation, stream, ctypes call, a torch op, a whole K4
            wrapper call on a tiny table)
  11 generic paths  kernels vs plain versions, per-step relative L2 within
            1e-10: 3 mixed-precision PIHNA steps (both solved to rtol
            1e-12) and 3 ADPM taxis-active steps (rtol 1e-11, each from a
            common state) on box_hex_mesh(6,6,6); then 3 ADPM steps on
            box_tet_mesh(4,4,4) against oracle/adpm_numpy.py, each step
            from the oracle's state (local parity), within 1e-8
  12 generic slice  PIHNA, 5 species, the bench deck and initial state on
            box_hex_mesh(48,48,48) with brain bounds: 5 warm-up steps,
            then 40 timed steps of run_steps (precision="mixed",
            precond_refresh=20, rtol=3e-11), launch counts reset just
            before; residuals <= rtol, state finite and non-negative; one
            run of 10 steps under torch.profiler for the device's busy
            share.  Then the ADPM legs on the affine path: bench.py:158-192
            (TET4 28^3, taxis amplitude 50, rtol 1e-9, precond_refresh=10),
            50 timed steps; and bench.py:241-276's deck regime (amplitude
            1e3, subcycle=16), 2 outer steps with every residual <= 1e-8.
            The compiled-C++ denominators (BASELINE_MEASURED.json) are
            printed beside the results, not asserted
  13 drivers  rdcfes_tpu_torch.cli.main in process, in generated case
            directories, launch counts reset just before each run and
            read just after: `-m pihna` on cases.make_pihna_case(n=28,
            n_steps=120) (131,712 TET4, the run/PIHNA deck; CSV header +
            13 rows, 13 VTU, a PVD of 13 DataSets, the last frame's five
            species finite and >= 0, K1, K2, K3 f64, K4 f64 launched and
            K3 f32 not); `-m adpm` on make_adpm_case(n=28, n_steps=40)
            with the taxis amplitude of bench.py:158-192 (outputs at 0,
            20, 40, the same checks); `-s` on box_hex_mesh(48,48,48)
            (110,592 HEX8) with the solid bench's deck (bench.py:290-341,
            loading_step 0.5: two load steps, each converged; every VTU
            field finite; K4 f32 and K5 f32 launched).  Each run prints
            its wall time, PerfLog's totals by phase, the solve phase's
            rate beside the compiled-C++ denominator (18.87 and 83.11
            steps/s, 2.95 s a load step; printed, not asserted) and its
            launches.  Then `python3 -m rdcfes_tpu_torch.cli -m pihna` as
            a subprocess on make_pihna_case(n=6, n_steps=3): exit code 0
            and the artifacts present

Then nvidia-smi's name and power limit of the card once more, and one
JSON line {"kernels": [...]}: one row per kernel variant with
the numbers of its first shapes, the launches of every path that ran
(zeros included) and, under "also", its rows at the other shapes; and as
the last line
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
from rdcfes_tpu_torch.fem.assembly import ell_structure
from rdcfes_tpu_torch.fem.bcsr import to_ell
from rdcfes_tpu_torch.fem.weakform import (block_diag, block_diag_affine,
                                           block_rhs, diffusion_presum)
from rdcfes_tpu_torch.mesh import box_hex_mesh, box_tet_mesh
from rdcfes_tpu_torch.models import adpm
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.solvers.newton import NewtonOptions
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.systems.solid import SolidSystem, element_kernels_cf
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
    "ell_matvec_f32": (CSRC + "ell_matvec.cu",
                       "rdcfes_tpu/fem/bcsr.py:60"),
    "ell_matvec_f64": (CSRC + "ell_matvec.cu",
                       "rdcfes_tpu/fem/bcsr.py:60"),
    "apply_generic_f32": (CSRC + "apply_generic.cu",
                          "rdcfes_tpu/fem/pallas_apply.py:263"),
    "apply_generic_f64": (CSRC + "apply_generic.cu",
                          "rdcfes_tpu/fem/pallas_apply.py:263"),
    "take_along_f32": (CSRC + "take_along.cu",
                       "scripts/microbench_calib.py:84"),
    "gather_interp_generic_f64": (CSRC + "gather_interp_generic.cu",
                                  "rdcfes_tpu/fem/pallas_perm.py:274"),
}
BENCH_STEPS = 120
# NVIDIA H100 SXM data sheet: HBM3 rate; dense f32 and f64 rates outside
# the tensor cores (the kernels here use the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F32: 67e12, F64: 34e12}
HEX_N = 48        # the generic slice: 48^3 = 110,592 HEX8, 117,649 nodes
HEX_WARMUP, HEX_STEPS = 5, 40
BRAIN = ((0, 150.0), (0, 180.0), (0, 150.0))
ADPM_STEPS = 50
# compiled-C++ denominators (BASELINE_MEASURED.json, 8 ideal MPI ranks)
ADPM_BASELINE_STEPS_PER_S = 83.11
ADPM_DECK_BASELINE_OUTER_STEPS_PER_S = 3.516
SOLID_N = 48  # bench.py:313: 48^3 = 110,592 HEX8, 117,649 nodes
SOLID_PT = 0.5
SOLID_BCS = {0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)}
SOLID_MATERIALS = {0: {"young": 1.0e3, "poisson": 0.3}}
SOLID_BENCH_OPTS = NewtonOptions(max_nonlinear_iterations=20,
                                 relative_residual_tolerance=1e-6,
                                 relative_step_tolerance=1e-6,
                                 reuse_tangent=True,
                                 linear_precision="mixed")
SOLID_EXACT_OPTS = NewtonOptions(max_nonlinear_iterations=20,
                                 relative_residual_tolerance=1e-10,
                                 relative_step_tolerance=1e-10,
                                 absolute_residual_tolerance=1e-10,
                                 linear_precision="f64")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------
def bench_case(mesh=None):
    """The headline bench leg's mesh (or `mesh`), deck and initial
    state."""
    if mesh is None:
        mesh = box_tet_mesh(28, 28, 28, bounds=BRAIN)
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


def adpm_case(mesh, amplitude):
    """The ADPM bench legs' deck and state on `mesh` (bench.py:158-181,
    :241-261): taxis amplitude 50 (taxis-active leg) or 1e3 (deck regime).
    Returns (params, u0 (N, 3), tracts (E, 3))."""
    p = adpm.default_params()
    p.update(
        dt=0.05,
        decay_PrP=1.0e-4, decay_PrP_pulse0=0.01, decay_PrP_pulse1=10.0,
        taxis1_A_b=amplitude, taxis1_A_b_pulse0=-1.0,
        taxis1_A_b_pulse1=0.01,
        taxis1_Tau=amplitude, taxis1_Tau_pulse0=-1.0,
        taxis1_Tau_pulse1=0.01,
        decay_Tau=1.0e1, decay_Tau_pulse0=0.0005, decay_Tau_pulse1=1.0e20,
        diffuse_A_b=2e-4, diffuse_A_b_pulse0=-1.0, diffuse_A_b_pulse1=1e20,
    )
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(0)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 1e-3 * np.exp(-r2 / (2 * 20.0**2))
    u0[:, 2] = 1e-4 * np.exp(-r2 / (2 * 15.0**2))
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    return p, u0, tracts


def adpm_oracle_case():
    """The ADPM oracle parity case (tests/test_parity_oracle.py:128-146):
    response functions, tract-gated taxis and diffusion all active."""
    mesh = box_tet_mesh(4, 4, 4, bounds=((0, 20.0), (0, 20.0), (0, 20.0)))
    p = adpm.default_params()
    p.update(dt=0.05,
             decay_PrP=1e-4, decay_PrP_pulse0=0.01, decay_PrP_pulse1=10.0,
             diffuse_A_b=0.05, taxis1_A_b=0.5, taxis2_A_b=0.2,
             produce_A_b=0.3, produce_A_b_s0=0.2, produce_A_b_s1=0.8,
             transform_A_b=0.1, transform_A_b_t0=0.01, transform_A_b_t1=0.1,
             transform_A_b_t2=0.5, transform_A_b_t3=0.9,
             decay_A_b=0.05,
             diffuse_Tau=0.02, taxis1_Tau=0.3, decay_Tau=1.0)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(5)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 0.3 * np.exp(-r2 / 30.0)
    u0[:, 2] = 0.1 * np.exp(-r2 / 20.0)
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    return mesh, p, u0, tracts


def make_adpm(mesh, dev, rtol, ops=K.KERNEL_OPS, precond_refresh=10):
    return TransientRDCSystem(mesh, 3, adpm.adpm_blocks, rtol=rtol,
                              precision="mixed",
                              precond_refresh=precond_refresh, device=dev,
                              ops=ops)


def adpm_fields(tracts, dev):
    return {"tracts": torch.as_tensor(tracts, dtype=F64, device=dev),
            "time": 1.0}


def make_system(mesh, dev, ops=K.KERNEL_OPS, precond_refresh=20,
                rtol=3e-11):
    return TransientRDCSystem(mesh, 5, pihna_blocks, rtol=rtol,
                              precision="mixed",
                              precond_refresh=precond_refresh, device=dev,
                              ops=ops)


def make_solid(n, dev, opts, tangent_precision, ops=K.KERNEL_OPS):
    """The solid bench leg's system (bench.py:290-341) on box_hex_mesh(n)."""
    return SolidSystem(box_hex_mesh(n, n, n), materials=SOLID_MATERIALS,
                       bcs=SOLID_BCS, penalty=1.0e6, newton=opts,
                       tangent_precision=tangent_precision, device=dev,
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
    return dev, card


def _ptxas_table(log: str):
    """(kernel, registers, spill stores, spill loads) per entry function
    of nvcc's -Xptxas -v output."""
    import re

    rows, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append((_demangle(name), int(m.group(1))) + spill)
            name = None
    return rows


def _demangle(sym: str) -> str:
    """'...20apply_generic_kernelIdLi5ELi8ELi8EE...' ->
    'apply_generic_kernel<d,5,8,8>' (kernels are named after their
    source: csrc/<stem>.cu holds <stem>_kernel)."""
    import re

    stems = "|".join(p.stem for p in _build.CSRC.glob("*.cu"))
    m = re.search(rf"((?:{stems})_kernel)(?:I([fd])((?:Li\d+E)*))?", sym)
    if not m:
        return sym
    args = [m.group(2)] + re.findall(r"Li(\d+)E", m.group(3) or "")
    return m.group(1) + (f"<{','.join(args)}>" if m.group(2) else "")


def phase_build():
    res = _build.build()
    _build.library()
    rows = _ptxas_table(res.log)
    say("1 build", seconds=f"{res.seconds:.3f}", lib=res.path.name,
        kernels=len(rows))
    for name, regs, st, ld in rows:
        print(f"    ptxas: {name} registers={regs} spill_stores={st} "
              f"spill_loads={ld}", flush=True)


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_b = n_bytes / PEAK_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def measure(phase, name, kern, plain, tol, library=None, n_bytes=0,
            flops=0.0, dtype=F64):
    """Kernel vs plain version on the same inputs, then the timings; the
    launches made here do not count (counts are reset before each main
    path)."""
    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    abs_err, rel = _err(out, ref)
    row = {"max_abs_err": abs_err, "rel_err": rel, "ms": cuda_ms(kern),
           "plain_ms": cuda_ms(plain),
           "library_ms": cuda_ms(library) if library else None,
           **bound(n_bytes, flops, dtype)}
    say(phase, name=name, max_abs_err=f"{abs_err:.3e}", rel_err=f"{rel:.3e}",
        tol=tol, ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
        library_ms=("none" if library is None
                    else f"{row['library_ms']:.4f}"),
        bound_ms=f"{row['bound_ms']:.4f}", bound_by=row["bound_by"])
    require(rel <= tol, f"{name}: relative error {rel:.3e} > {tol}")
    return row


def _err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    return abs_err, abs_err / scale


def run_cases(phase, cases, main, also, label=""):
    """measure() every case.  A key is a variant name, or 'variant@what'
    for a second shape of the same variant.  Rows of plain keys without a
    label go to main[variant], the others to also[variant][label what]."""
    for key, c in cases.items():
        variant, _, sub = key.partition("@")
        tag = " ".join(x for x in (label, sub) if x)
        row = measure(phase, f"{variant} ({tag})" if tag else variant, **c)
        if tag:
            also.setdefault(variant, {})[tag] = row
        else:
            main[variant] = row


def restrict_case(flat, s):
    """K4 on system `s`: flat (W, K E) -> (W, N) through s.node_gather,
    beside index_add_ over the flattened connectivity."""
    W, dt, ng = flat.shape[0], flat.dtype, s.node_gather
    N = s.mesh.n_nodes
    conn_flat = s.conn_T.reshape(-1).long()
    live = int((ng < flat.shape[1]).sum())
    return dict(
        kern=lambda: K.restrict(flat, ng),
        plain=lambda: K.restrict_plain(flat, ng),
        tol=1e-5 if dt == F32 else 1e-13,
        library=lambda: torch.zeros((W, N), dtype=dt, device=flat.device
                                    ).index_add_(1, conn_flat, flat),
        n_bytes=nbytes(flat, ng) + W * N * flat.element_size(),
        flops=float(W * live), dtype=dt)


def affine_cases(phase, s, u, blocks_of):
    """K1-K4 cases on the affine (TET4) system `s` at the state u (V, N)
    f64, with the coefficient blocks blocks_of(u_qp, grad_qp) builds
    there: every launch a step makes, at the step's shapes (K4 for the
    right-hand side and both matvecs, W = V, and for the block-Jacobi
    diagonal, W = V V)."""
    V, mesh = s.n_vars, s.mesh
    u_qp, gx1 = K.gather_interp_affine_plain(u, s.conn_T, s.phi, s.dphi0)
    grad_qp = gx1[:, None].expand(V, u_qp.shape[1], 3, gx1.shape[-1])
    wfb = blocks_of(u_qp, grad_qp)
    rhs = K.stack_rhs(wfb)
    st64 = K.stack_apply(wfb, diffusion_presum(wfb, s.JxW))
    wfb32 = wfb.cast(F32)
    st32 = K.stack_apply(wfb32, diffusion_presum(wfb32, s.JxW32))
    u32 = u.to(F32)
    flat64 = K.rhs_affine_plain(rhs, s.JxW, s.phi, s.dphi0).reshape(V, -1)
    flat32 = K.apply_affine_plain(u32, s.conn_T, s.phi, s.JxW32, s.dphi0_32,
                                  st32).reshape(V, -1)
    diag64 = block_diag_affine(wfb, s.phi, s.JxW, s.dphi).reshape(V * V, -1)
    E = mesh.n_elems
    Kc, Q = s.conn_T.shape[0], s.JxW.shape[0]
    fe = flat64.reshape(V, Kc, E)
    nC, nD, nE = len(st64.idxC), len(st64.idxD), len(st64.idxE)
    apply_flops = 2.0 * E * Kc * (V * (Q + 3) + nC * Q + 3 * nD * Q + 3 * nE)
    cases = {
        "gather_interp_affine_f64": dict(
            kern=lambda: K.gather_interp_affine(u, s.conn_T, s.phi, s.dphi0),
            plain=lambda: K.gather_interp_affine_plain(u, s.conn_T, s.phi,
                                                       s.dphi0), tol=1e-13,
            n_bytes=nbytes(u, s.conn_T, s.dphi0, u_qp, gx1),
            flops=2.0 * V * Kc * E * (Q + 3)),
        "rhs_affine_f64": dict(
            kern=lambda: K.rhs_affine(rhs, s.JxW, s.phi, s.dphi0),
            plain=lambda: K.rhs_affine_plain(rhs, s.JxW, s.phi, s.dphi0),
            tol=1e-13, n_bytes=nbytes(rhs.A, rhs.B, s.JxW, s.dphi0, fe),
            flops=2.0 * Kc * Q * E * (len(rhs.idxA) + 3 * len(rhs.idxB))),
        "apply_affine_f32": dict(
            kern=lambda: K.apply_affine(u32, s.conn_T, s.phi, s.JxW32,
                                        s.dphi0_32, st32),
            plain=lambda: K.apply_affine_plain(u32, s.conn_T, s.phi, s.JxW32,
                                               s.dphi0_32, st32), tol=1e-5,
            n_bytes=nbytes(u32, s.conn_T, s.JxW32, s.dphi0_32, st32.C,
                           st32.D, st32.Epre, flat32), flops=apply_flops,
            dtype=F32),
        "apply_affine_f64": dict(
            kern=lambda: K.apply_affine(u, s.conn_T, s.phi, s.JxW, s.dphi0,
                                        st64),
            plain=lambda: K.apply_affine_plain(u, s.conn_T, s.phi, s.JxW,
                                               s.dphi0, st64), tol=1e-13,
            n_bytes=nbytes(u, s.conn_T, s.JxW, s.dphi0, st64.C, st64.D,
                           st64.Epre, fe), flops=apply_flops),
        "restrict_f32": restrict_case(flat32, s),
        "restrict_f64": restrict_case(flat64, s),
        "restrict_f64@diagonal": restrict_case(diag64, s),
    }
    say(phase + " shapes", V=V, K=Kc, Q=Q, E=E, N=mesh.n_nodes,
        C=s.node_gather.shape[0], live=f"C:{nC} D:{nD} E:{nE} "
        f"A:{len(rhs.idxA)} B:{len(rhs.idxB)}")
    return cases


def phase_kernels(dev, also):
    mesh, params, u0 = bench_case()
    s = make_system(mesh, dev)
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    results = {}
    run_cases("2 kernel", affine_cases(
        "2 kernels", s, u, lambda uq, gq: pihna_blocks(uq, gq, {}, params)),
        results, also)
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
    missing = [k for k in K.TRANSIENT_VARIANTS if counts[k] == 0]
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    return counts


def phase_solid_kernels(dev, S):
    """K5 and K4's matrix assembly at the solid bench's shapes, on the
    tangent assembled at seeded perturbed positions."""
    rng = np.random.default_rng(6)
    N = S.mesh.n_nodes
    h = 1.0 / SOLID_N
    X0 = S.initial_positions()
    x = X0 + torch.as_tensor(0.05 * h * rng.standard_normal((N, 3)),
                             dtype=F64, device=dev)
    tab, tab32 = S.tables, S.tables32
    pt = torch.tensor(SOLID_PT, dtype=F64, device=dev)
    args = lambda t: (t["X0e_cf"], t["young"], t["poisson"], t["fibre_k"],
                      t["rates"], t["fibres"])
    flat64 = element_kernels_cf("HEX8", x, S.conn, *args(tab), pt)[1]
    flat64 = flat64.reshape(9, -1)
    flat32 = element_kernels_cf("HEX8", x.to(F32), S.conn, *args(tab32),
                                pt.to(F32))[1].reshape(9, -1)
    _, values = S.assemble(x.T.contiguous(), SOLID_PT)  # f32 tangent
    cols_np, slot_np = ell_structure(S.sp)
    cols = torch.as_tensor(cols_np, device=dev)
    vell32 = to_ell(values, torch.as_tensor(slot_np, device=dev))
    vell64 = vell32.to(F64)
    xv64 = torch.as_tensor(rng.standard_normal((3, N)), dtype=F64,
                           device=dev)
    xv32 = xv64.to(F32)
    nnz, sg = S.sp.nnz, S.slot_gather
    slots_flat = torch.as_tensor(S.sp.slots_flat_cf(), device=dev).long()
    # the same operator as a scalar CSR matrix (3N x 3N, node-major dofs)
    # for the library SpMV; built once, outside the timings
    rows = torch.as_tensor(S.sp.rows, device=dev).long()
    bcols = torch.as_tensor(S.sp.cols, device=dev).long()
    vw = torch.arange(3, device=dev)
    r_idx = (3 * rows[None, None, :] + vw[:, None, None]).expand(3, 3, nnz)
    c_idx = (3 * bcols[None, None, :] + vw[None, :, None]).expand(3, 3, nnz)
    coo = torch.sparse_coo_tensor(
        torch.stack([r_idx.reshape(-1), c_idx.reshape(-1)]),
        values.reshape(-1).to(F64), (3 * N, 3 * N)).coalesce()
    csr64 = coo.to_sparse_csr()
    csr32 = csr64.to(F32)
    del coo, r_idx, c_idx
    xi64, xi32 = xv64.T.reshape(-1), xv32.T.reshape(-1)
    mv_flops = 2.0 * 9 * nnz
    entries = int((sg < flat32.shape[1]).sum())
    cases = {
        "restrict_f32": dict(
            kern=lambda: K.restrict(flat32, sg),
            plain=lambda: K.restrict_plain(flat32, sg), tol=1e-5,
            library=lambda: torch.zeros((9, nnz), dtype=F32, device=dev
                                        ).index_add_(1, slots_flat, flat32),
            n_bytes=nbytes(flat32, sg) + 9 * nnz * 4,
            flops=9.0 * entries, dtype=F32),
        "restrict_f64": dict(
            kern=lambda: K.restrict(flat64, sg),
            plain=lambda: K.restrict_plain(flat64, sg), tol=1e-13,
            library=lambda: torch.zeros((9, nnz), dtype=F64, device=dev
                                        ).index_add_(1, slots_flat, flat64),
            n_bytes=nbytes(flat64, sg) + 9 * nnz * 8,
            flops=9.0 * entries),
        "ell_matvec_f32": dict(
            kern=lambda: K.ell_matvec(vell32, cols, xv32),
            plain=lambda: K.ell_matvec_plain(vell32, cols, xv32), tol=1e-5,
            library=lambda: torch.mv(csr32, xi32),
            n_bytes=nbytes(vell32, cols, xv32, xv32), flops=mv_flops,
            dtype=F32),
        "ell_matvec_f64": dict(
            kern=lambda: K.ell_matvec(vell64, cols, xv64),
            plain=lambda: K.ell_matvec_plain(vell64, cols, xv64), tol=1e-13,
            library=lambda: torch.mv(csr64, xi64),
            n_bytes=nbytes(vell64, cols, xv64, xv64), flops=mv_flops),
    }
    results = {name: measure("6 solid kernel", name, **c)
               for name, c in cases.items()}
    lib_err = float((torch.mv(csr64, xi64).reshape(N, 3).T
                     - K.ell_matvec_plain(vell64, cols, xv64)).abs().max())
    say("6 solid kernels", shapes=f"E={S.mesh.n_elems} N={N} nnz={nnz} "
        f"L={cols.shape[0]} C={sg.shape[0]} KKE={flat32.shape[1]}",
        library_spmv_max_abs_diff=f"{lib_err:.3e}")
    for name, row in results.items():
        nb = cases[name]["n_bytes"]
        say("6 achieved", name=name, bytes=nb,
            tb_per_s=f"{nb / (row['ms'] * 1e-3) / 1e12:.4f}")
    return results


def phase_solid_paths(dev):
    """One exact-f64 load step on box_hex_mesh(12,12,12), kernels vs
    plain versions."""
    us = []
    for ops in (K.KERNEL_OPS, K.PLAIN_OPS):
        s = make_solid(12, dev, SOLID_EXACT_OPTS, "f64", ops=ops)
        r = s.run_solver(s.initial_positions(), SOLID_PT)
        require(r.converged, "exact-f64 load step did not converge")
        us.append(s.displacement(r.x))
        say("7 path", ops="kernels" if ops is K.KERNEL_OPS else "plain",
            newton_iters=r.iters, linear_iters=r.linear_iters,
            r_ratio=f"{r.residual_norm / r.initial_residual_norm:.3e}")
    err = rel_l2(us[0], us[1])
    say("7 paths", rel_l2_displacement=f"{err:.3e}", bar=1e-10)
    require(err <= 1e-10, f"solid kernel vs plain path: {err:.3e}")


class _StageTimer:
    """Synchronised host-clock totals of the outermost assemble,
    assemble_residual and linear-solve calls of one load step."""

    def __init__(self, S):
        self.S, self.totals, self.calls, self.depth = S, {}, {}, 0
        for obj, attr, name in ((S, "assemble", "tangent_assembly"),
                                (S, "assemble_residual", "residual_only"),
                                (S._newton, "_linear_solve", "linear")):
            setattr(obj, attr, self._wrap(name, getattr(obj, attr)))

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1
            self.depth -= 1
            return out
        return timed

    def remove(self):
        for obj, attr in ((self.S, "assemble"), (self.S, "assemble_residual"),
                          (self.S._newton, "_linear_solve")):
            delattr(obj, attr)


def _device_busy_s(prof) -> float:
    """Sum of the CUDA kernel intervals of a trace (one stream)."""
    cuda = torch.autograd.DeviceType.CUDA
    return 1e-6 * sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == cuda)


def phase_solid_slice(dev, S):
    x0 = S.initial_positions()
    S.run_solver(x0, SOLID_PT)  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = S.run_solver(x0, SOLID_PT)
    x = res.x.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    ratio = res.residual_norm / res.initial_residual_norm
    say("8 solid slice", seconds=f"{wall:.4f}", newton_iters=res.iters,
        linear_iters_total=res.linear_iters, converged=res.converged,
        r_ratio=f"{ratio:.3e}", n_nodes=S.mesh.n_nodes,
        n_elems=S.mesh.n_elems, nnz=S.sp.nnz,
        baseline_s=2.95)
    say("8 launches", **{k: counts[k] for k in K.SOLID_VARIANTS})
    # witness independent of the solver's bookkeeping: the plain f64
    # residual at the final and the initial positions
    P = make_solid(SOLID_N, dev, SOLID_BENCH_OPTS, "f64", ops=K.PLAIN_OPS)
    r_fin = float(torch.linalg.vector_norm(
        P.assemble_residual(res.x.T.contiguous(), SOLID_PT)))
    r_ini = float(torch.linalg.vector_norm(
        P.assemble_residual(x0.T.contiguous(), SOLID_PT)))
    del P
    say("8 witness", plain_f64_r_ratio=f"{r_fin / r_ini:.3e}", bar=1e-6)
    require(np.isfinite(x).all(), "non-finite positions")
    require(res.converged, "the load step did not converge")
    require(r_fin / r_ini <= 1e-6,
            f"plain f64 |R|/|R0| {r_fin / r_ini:.3e} > 1e-6")
    missing = [k for k in K.SOLID_VARIANTS if counts[k] == 0]
    require(not missing, f"kernels never launched on the solid path: "
            f"{missing}")
    # where the time goes: one run timed stage by stage (synchronised),
    # one under the profiler for the device's busy share
    timer = _StageTimer(S)
    t0 = time.perf_counter()
    S.run_solver(x0, SOLID_PT)
    torch.cuda.synchronize()
    staged = time.perf_counter() - t0
    timer.remove()
    say("8 stages", seconds=f"{staged:.4f}", **{
        k: f"{v:.4f}s/{timer.calls[k]}" for k, v in timer.totals.items()})
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.run_solver(x0, SOLID_PT)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    busy = _device_busy_s(prof)
    say("8 profile", seconds=f"{traced:.4f}", device_busy_s=f"{busy:.4f}",
        busy_share=f"{busy / traced:.4f}")
    top = sorted(prof.key_averages(), key=lambda e: -getattr(
        e, "self_device_time_total", 0.0))[:8]
    for e in top:
        print(f"    device: {e.key[:60]} "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms "
              f"x{e.count}", flush=True)
    return counts


def generic_cases(tag, s, x64, blocks_of):
    """K8, K6 and K4 cases on the generic (HEX8) system `s` at the state
    x64 (V, N), with the coefficient blocks blocks_of(u_qp, grad_qp)
    builds there: every launch a step makes, at the step's shapes."""
    V, E = s.n_vars, s.mesh.n_elems
    Kc, Q = s.conn_T.shape[0], s.JxW.shape[0]
    u_qp, grad_qp = K.gather_interp_generic_plain(x64, s.conn_T, s.phi,
                                                  s.dphi)
    wfb = blocks_of(u_qp, grad_qp)
    interp_bytes = nbytes(x64, s.conn_T, s.dphi, u_qp, grad_qp)
    del u_qp, grad_qp
    st64 = K.stack_apply_generic(wfb)
    st32 = K.stack_apply_generic(wfb.cast(F32))
    x32 = x64.to(F32)
    nC, nD, nE = len(st64.idxC), len(st64.idxD), len(st64.idxE)
    # interpolation, the (v, w) responses, the projection back
    flops = 2.0 * E * Q * (4 * Kc * V + nC + 3 * nD + 3 * nE
                           + V * (4 + 4 * Kc))
    cases = {"gather_interp_generic_f64": dict(
        kern=lambda: K.gather_interp_generic(x64, s.conn_T, s.phi, s.dphi),
        plain=lambda: K.gather_interp_generic_plain(x64, s.conn_T, s.phi,
                                                    s.dphi),
        tol=1e-13, n_bytes=interp_bytes, flops=2.0 * 4 * V * Q * Kc * E)}
    for name, x, JxW, dphi, st, tol, dt in (
            ("apply_generic_f32", x32, s.JxW32, s.dphi32, st32, 1e-5, F32),
            ("apply_generic_f64", x64, s.JxW, s.dphi, st64, 1e-13, F64)):
        out_bytes = V * Kc * E * x.element_size()
        cases[name] = dict(
            kern=lambda x=x, JxW=JxW, dphi=dphi, st=st: K.apply_generic(
                x, s.conn_T, s.phi, JxW, dphi, st),
            plain=lambda x=x, JxW=JxW, dphi=dphi, st=st:
                K.apply_generic_plain(x, s.conn_T, s.phi, JxW, dphi, st),
            tol=tol, flops=flops, dtype=dt,
            n_bytes=nbytes(x, s.conn_T, JxW, dphi, st.C, st.D, st.E)
            + out_bytes)
    # K4 at this mesh's node_gather: the matvecs' and the right-hand
    # side's restriction (W = V) and the block-Jacobi diagonal's (W = V V)
    flat32 = K.apply_generic_plain(x32, s.conn_T, s.phi, s.JxW32, s.dphi32,
                                   st32).reshape(V, -1)
    flat64 = block_rhs(wfb, s.phi, s.JxW, s.dphi).reshape(V, -1)
    diag64 = block_diag(wfb, s.phi, s.JxW, s.dphi).reshape(V * V, -1)
    cases["restrict_f32@hex8"] = restrict_case(flat32, s)
    cases["restrict_f64@hex8"] = restrict_case(flat64, s)
    cases["restrict_f64@hex8 diagonal"] = restrict_case(diag64, s)
    say("9 blocks", deck=tag, V=V, live=f"C:{nC} D:{nD} E:{nE}",
        f32_bytes=cases["apply_generic_f32"]["n_bytes"],
        f64_bytes=cases["apply_generic_f64"]["n_bytes"])
    return cases


def phase_generic_kernels(dev, S, also):
    """K8, K6 and K4 at the HEX8 slice's shapes with PIHNA's and with
    ADPM's live blocks; K1-K4 at the ADPM bench legs' shapes; K7 at the
    calibration's shapes."""
    mesh = S.mesh
    _, params, u0 = bench_case(mesh)
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    results = {}
    run_cases("9 generic kernel", generic_cases(
        "pihna", S, u, lambda uq, gq: pihna_blocks(uq, gq, {}, params)),
        results, also)
    # ADPM's taxis-active blocks on the same mesh: V = 3, live D planes
    pa, ua0, tracts = adpm_case(mesh, 50.0)
    A = make_adpm(mesh, dev, 1e-9)
    ua = torch.as_tensor(np.ascontiguousarray(ua0.T), dtype=F64, device=dev)
    f = adpm_fields(tracts, dev)
    run_cases("9 generic kernel", generic_cases(
        "adpm", A, ua, lambda uq, gq: adpm.adpm_blocks(uq, gq, f, pa)),
        results, also, label="adpm")
    del A, f
    # K6 where E is odd and not a multiple of the tile (125 HEX8): rows
    # that are not 16-byte aligned and a ragged last tile
    odd = make_system(box_hex_mesh(5, 5, 5, bounds=BRAIN), dev)
    _, _, uo0 = bench_case(odd.mesh)
    uo = torch.as_tensor(np.ascontiguousarray(uo0.T), dtype=F64, device=dev)
    run_cases("9 generic kernel", {
        k: c for k, c in generic_cases(
            "pihna odd E", odd, uo,
            lambda uq, gq: pihna_blocks(uq, gq, {}, params)).items()
        if k.startswith("apply_generic")}, results, also, label="odd E")
    del odd
    # the ADPM bench legs' own mesh and blocks (TET4 28^3, V = 3)
    tet = box_tet_mesh(28, 28, 28, bounds=BRAIN)
    pa, ua0, tracts = adpm_case(tet, 50.0)
    A = make_adpm(tet, dev, 1e-9)
    ua = torch.as_tensor(np.ascontiguousarray(ua0.T), dtype=F64, device=dev)
    f = adpm_fields(tracts, dev)
    run_cases("9 affine kernel", affine_cases(
        "9 adpm tet4", A, ua, lambda uq, gq: adpm.adpm_blocks(uq, gq, f, pa)),
        results, also, label="adpm tet4")
    del A, f
    rng = np.random.default_rng(0)
    Sx, M = 192, 4608
    tbl = torch.as_tensor(rng.standard_normal((Sx, 128)), dtype=F32,
                          device=dev)
    idx = torch.as_tensor(rng.integers(0, Sx, (M, 128)), dtype=torch.int32,
                          device=dev)
    idx64 = idx.long()
    results["take_along_f32"] = measure(
        "9 generic kernel", "take_along_f32",
        kern=lambda: K.take_along(tbl, idx),
        plain=lambda: K.take_along_plain(tbl, idx), tol=0.0,
        library=lambda: torch.gather(tbl, 0, idx64),
        n_bytes=nbytes(tbl, idx) + M * 128 * 4, flops=0.0, dtype=F32)
    say("9 generic kernels", shapes=f"K=8 Q=8 E={mesh.n_elems} "
        f"N={mesh.n_nodes} C={S.node_gather.shape[0]}; adpm tet4 "
        f"E={tet.n_elems} N={tet.n_nodes}; take_along S={Sx} M={M} L=128")
    return results


def _fit(label, body, ns=(8, 40)):
    """time = a + b n of n back-to-back eager bodies closed by one
    synchronize: median host time of 3 runs for each n.  Beside it the
    same fit of the loop alone, before the synchronize (the host's cost
    of issuing a body, its launches included), and the CUDA-event time of
    one body on the device: b is the larger of the two where either
    bounds it."""
    def loop_ms(n):
        for _ in range(3):
            body()
        ts, issue = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                body()
            issue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts)), 1e3 * float(np.median(issue))
    (t1, h1), (t2, h2) = loop_ms(ns[0]), loop_ms(ns[1])
    b = (t2 - t1) / (ns[1] - ns[0])
    a = t1 - b * ns[0]
    host_b = (h2 - h1) / (ns[1] - ns[0])
    dev_ms = cuda_ms(body)
    say("10 fit", body=repr(label), per_body_ms=f"{b:.5f}",
        fixed_ms=f"{a:.5f}", n8_ms=f"{t1:.5f}", n40_ms=f"{t2:.5f}",
        host_per_body_ms=f"{host_b:.5f}", device_ms=f"{dev_ms:.5f}")
    return {"per_body_ms": b, "fixed_ms": a, "host_per_body_ms": host_b,
            "device_ms": dev_ms}


def _host_us(label, fn, n=200):
    """Mean host time of one call of fn over n calls issued back to back
    (the queue drained before; n stays far below the launch queue's
    depth)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    say("10 host", piece=repr(label), us_per_call=f"{us:.3f}")
    return us


def phase_calibration(dev):
    """Per-launch host cost against real work, for unfoldable bodies of
    known device cost (scripts/microbench_calib.py:41-109)."""
    rng = np.random.default_rng(0)
    box = {}

    def chain(name, x0, fn):
        box[name] = x0

        def body():
            box[name] = fn(box[name])
        return body

    scalar = torch.tensor(1.5, dtype=F64, device=dev)
    big = torch.as_tensor(rng.standard_normal(16_777_216), dtype=F32,
                          device=dev)
    sm = torch.as_tensor(rng.standard_normal((4_608, 128)), dtype=F32,
                         device=dev)
    V, N, C, KE = 5, 24_389, 24, 4 * 131_712
    ng = torch.as_tensor(rng.integers(0, KE + 1, (C, N)), dtype=torch.int32,
                         device=dev)
    buf = torch.as_tensor(rng.standard_normal((V, KE)), dtype=F32,
                          device=dev)
    Sx, M = 192, 4_608
    tbl = torch.as_tensor(rng.standard_normal((Sx, 128)), dtype=F32,
                          device=dev)
    idx = torch.as_tensor(rng.integers(0, Sx, (M, 128)), dtype=torch.int32,
                          device=dev)
    # K6 f32 and K3 f32 at host-bound sizes, on the PIHNA blocks at the
    # bench state: the launch path's host cost per matvec apply
    hex_s = make_system(box_hex_mesh(12, 12, 12, bounds=BRAIN), dev)
    tet_s = make_system(box_tet_mesh(12, 12, 12, bounds=BRAIN), dev)
    _, params, _ = bench_case(hex_s.mesh)
    applies = {}
    for name, s in (("apply_generic K6 f32", hex_s),
                    ("apply_affine K3 f32", tet_s)):
        _, _, u0 = bench_case(s.mesh)
        u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64,
                            device=dev)
        if s is hex_s:
            uq, gq = K.gather_interp_generic_plain(u, s.conn_T, s.phi,
                                                   s.dphi)
            st = K.stack_apply_generic(
                pihna_blocks(uq, gq, {}, params).cast(F32))
            args = (s.conn_T, s.phi, s.JxW32, s.dphi32, st)
            applies[name] = (K.apply_generic, u.to(F32), args)
        else:
            uq, g1 = K.gather_interp_affine_plain(u, s.conn_T, s.phi,
                                                  s.dphi0)
            gq = g1[:, None].expand(5, uq.shape[1], 3, g1.shape[-1])
            wfb = pihna_blocks(uq, gq, {}, params).cast(F32)
            st = K.stack_apply(wfb, diffusion_presum(wfb, s.JxW32))
            args = (s.conn_T, s.phi, s.JxW32, s.dphi0_32, st)
            applies[name] = (K.apply_affine, u.to(F32), args)
    K.reset_launch_counts()
    fits = {
        "scalar sqrt chain": _fit("scalar sqrt chain", chain(
            "s", scalar, lambda c: torch.sqrt(c * c + 1.0))),
        "stream sqrt 67MB": _fit("stream sqrt 67MB", chain(
            "b", big, lambda c: torch.sqrt(c * c + 1e-9))),
        "stream sqrt 2.3MB": _fit("stream sqrt 2.3MB", chain(
            "m", sm, lambda c: torch.sqrt(c * c + 1e-9))),
        "transpose 2.3MB + sqrt": _fit("transpose 2.3MB + sqrt", chain(
            "t", sm, lambda c: torch.sqrt(
                c.T.reshape(4_608, 128) ** 2 + 1e-9))),
        "restrict K4 f32": _fit("restrict K4 f32",
                                lambda: K.restrict(buf, ng)),
        "take_along K7": _fit("take_along K7",
                              lambda: K.take_along(tbl, idx)),
    }
    for name, (fn, x, args) in applies.items():
        fits[name] = _fit(name, lambda fn=fn, x=x, args=args: fn(x, *args))
    # the pieces of one launch through a wrapper, host time each
    tiny_ng = torch.as_tensor(rng.integers(0, 1025, (4, 256)),
                              dtype=torch.int32, device=dev)
    tiny = torch.as_tensor(rng.standard_normal((5, 1024)), dtype=F32,
                           device=dev)
    # the floor of a CUDA-event time: one tiny elementwise kernel
    fits["neg (5, 1024) f32"] = _fit("neg (5, 1024) f32",
                                     lambda: torch.neg(tiny))
    empty_plan = K._plan("restrict_plan", 0, 0, 0, dev.index)
    kf = K._fn("restrict_f32")
    raw = torch._C._cuda_getCurrentRawStream
    for label, fn in (
            ("torch.empty (5, 1024) f32", lambda: torch.empty(
                (5, 1024), dtype=F32, device=dev)),
            ("new_empty (5, 1024)", lambda: tiny.new_empty((5, 1024))),
            ("raw current stream", lambda: raw(dev.index)),
            ("torch.cuda.current_device", torch.cuda.current_device),
            ("ctypes call, no launch (K4, N = 0)",
             lambda: kf(empty_plan[1], 0, 0, 1, 0, 0)),
            ("torch.neg (5, 1024) f32", lambda: torch.neg(tiny)),
            ("K4 wrapper, (5, 1024) -> 256 nodes",
             lambda: K.restrict(tiny, tiny_ng))):
        fits["host: " + label] = {"us_per_call": _host_us(label, fn)}
    counts = K.launch_counts()
    say("10 launches", **{k: counts[k] for k in (
        "take_along_f32", "restrict_f32", "apply_generic_f32",
        "apply_affine_f32")})
    require(all(counts[k] > 0 for k in (
        "take_along_f32", "restrict_f32", "apply_generic_f32",
        "apply_affine_f32")), "the calibration missed a kernel")
    return fits, counts


def phase_generic_paths(dev):
    """Kernels vs plain versions on small HEX8 meshes, and ADPM on TET4
    against the independent NumPy/SuperLU oracle."""
    from oracle.adpm_numpy import AdpmOracle

    hexm = box_hex_mesh(6, 6, 6, bounds=((0, 20.0), (0, 20.0), (0, 20.0)))
    _, params, _ = bench_case(hexm)
    r2 = ((hexm.coords - hexm.coords.mean(0)) ** 2).sum(axis=1)
    rng = np.random.default_rng(0)
    u0 = np.zeros((hexm.n_nodes, 5))
    u0[:, 1] = 2000.0 * np.exp(-r2 / 30.0)
    u0[:, 2] = 500.0 * np.exp(-r2 / 25.0)
    u0[:, 3] = 7200.0 * (1.0 + 0.1 * rng.random(hexm.n_nodes))
    u0[:, 4] = 1e-10
    # both solves converge to rtol 1e-12, so that what is left between
    # them is the kernels' arithmetic and not two solver exits at 3e-11
    a = make_system(hexm, dev, rtol=1e-12)
    b = make_system(hexm, dev, ops=K.PLAIN_OPS, rtol=1e-12)
    sa, sb = a.initial_state(u0), b.initial_state(u0)
    worst = 0.0
    for _ in range(3):
        sa, ia, ra = a.step(sa, params=params)
        sb, ib, rb = b.step(sb, params=params)
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
        require(max(float(ra), float(rb)) <= 1e-12,
                f"HEX8 PIHNA residuals {float(ra):.3e}, {float(rb):.3e}")
    say("11 paths", model="pihna", mesh="hex 6^3", steps=3, rtol=1e-12,
        worst_rel_l2=f"{worst:.3e}", bar=1e-10)
    require(worst < 1e-10, f"HEX8 PIHNA kernel vs plain path: {worst:.3e}")

    # ADPM taxis-active: every step from a common state (the kernel
    # path's), since taxis amplifies differences along a trajectory
    pa, ua0, tracts = adpm_case(hexm, 50.0)
    ua0[:, 1] = 1e-3 * np.exp(-r2 / 30.0)
    ua0[:, 2] = 1e-4 * np.exp(-r2 / 20.0)
    f = adpm_fields(tracts, dev)
    a = make_adpm(hexm, dev, 1e-11, precond_refresh=1)
    b = make_adpm(hexm, dev, 1e-11, ops=K.PLAIN_OPS, precond_refresh=1)
    sa = a.initial_state(ua0)
    worst = 0.0
    for _ in range(3):
        sb, _, _ = b.step(sa, fields=f, params=pa)
        sa, _, _ = a.step(sa, fields=f, params=pa)
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
    say("11 paths", model="adpm taxis-active", mesh="hex 6^3", steps=3,
        worst_rel_l2=f"{worst:.3e}", bar=1e-10)
    require(worst < 1e-10, f"HEX8 ADPM kernel vs plain path: {worst:.3e}")

    mesh, po, uo, tr = adpm_oracle_case()
    orc = AdpmOracle(mesh.coords, mesh.connectivity, tr, po)
    s = make_adpm(mesh, dev, 3e-11, precond_refresh=1)
    f = adpm_fields(tr, dev)
    worst = 0.0
    for _ in range(3):
        st, _, _ = s.step(s.initial_state(uo), fields=f, params=po)
        uo, _ = orc.step(uo, time=1.0)
        worst = max(worst, rel_l2(st["u"], uo))
    say("11 oracle", model="adpm", mesh="tet 4^3", steps=3,
        worst_local_rel_l2=f"{worst:.3e}", bar=1e-8)
    require(np.isfinite(uo).all() and worst < 1e-8,
            f"ADPM oracle parity violated: worst rel L2 {worst:.3e}")


def _timed_run(s, state, n, **kw):
    """run_steps with the launch counts reset just before and read just
    after; the state is fetched to the host inside the clock."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    st, its, ress = s.run_steps(state, n, **kw)
    u = st["u"].cpu().numpy()
    wall = time.perf_counter() - t0
    return u, its, ress, wall, K.launch_counts()


def _require_launched(counts, variants, what):
    missing = [k for k in variants if counts[k] == 0]
    require(not missing, f"kernels never launched on {what}: {missing}")


def phase_generic_slice(dev, S):
    from torch.profiler import ProfilerActivity, profile

    mesh = S.mesh
    _, params, u0 = bench_case(mesh)
    S.run_steps(S.initial_state(u0), HEX_WARMUP, params=params)
    u, its, ress, wall, counts = _timed_run(S, S.initial_state(u0),
                                            HEX_STEPS, params=params)
    say("12 hex8 pihna", steps=HEX_STEPS, seconds=f"{wall:.4f}",
        steps_per_s=f"{HEX_STEPS / wall:.4f}",
        inner_iters_total=int(its.sum()),
        final_residual=f"{float(ress[-1]):.3e}",
        max_residual=f"{float(ress.max()):.3e}", n_nodes=mesh.n_nodes,
        n_elems=mesh.n_elems)
    say("12 hex8 launches", **{k: counts[k] for k in K.GENERIC_VARIANTS})
    require(np.isfinite(u).all(), "non-finite state")
    require((u >= 0).all(), "negative state after the clamp")
    require(float(ress.max()) <= 3e-11,
            f"residual {float(ress.max()):.3e} > 3e-11")
    _require_launched(counts, K.GENERIC_VARIANTS, "the HEX8 path")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.run_steps(S.initial_state(u0), 10, params=params)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    busy = _device_busy_s(prof)
    say("12 hex8 profile", steps=10, seconds=f"{traced:.4f}",
        device_busy_s=f"{busy:.4f}", busy_share=f"{busy / traced:.4f}")
    top = sorted(prof.key_averages(), key=lambda e: -getattr(
        e, "self_device_time_total", 0.0))[:8]
    for e in top:
        print(f"    device: {e.key[:60]} "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms "
              f"x{e.count}", flush=True)
    paths = {"hex8_pihna": counts}

    # the ADPM legs on the affine path
    tet = box_tet_mesh(28, 28, 28, bounds=BRAIN)
    pa, ua0, tracts = adpm_case(tet, 50.0)
    A = make_adpm(tet, dev, 1e-9)
    f = adpm_fields(tracts, dev)
    A.run_steps(A.initial_state(ua0), 10, fields=f, params=pa)
    u, its, ress, wall, counts = _timed_run(A, A.initial_state(ua0),
                                            ADPM_STEPS, fields=f, params=pa)
    say("12 adpm taxis-active", steps=ADPM_STEPS, seconds=f"{wall:.4f}",
        steps_per_s=f"{ADPM_STEPS / wall:.4f}",
        inner_iters_total=int(its.sum()),
        final_residual=f"{float(ress[-1]):.3e}",
        max_residual=f"{float(ress.max()):.3e}", n_nodes=tet.n_nodes,
        n_elems=tet.n_elems,
        baseline_steps_per_s=ADPM_BASELINE_STEPS_PER_S)
    say("12 adpm launches", **{k: counts[k] for k in K.TRANSIENT_VARIANTS})
    require(np.isfinite(u).all(), "ADPM: non-finite state")
    require(float(ress.max()) <= 1e-9,
            f"ADPM: residual {float(ress.max()):.3e} > 1e-9")
    _require_launched(counts, K.TRANSIENT_VARIANTS, "the ADPM path")
    paths["adpm"] = counts

    pd, ud0, tracts = adpm_case(tet, 1e3)
    D = make_adpm(tet, dev, 3e-11)
    D.run_steps(D.initial_state(ud0), 1, fields=f, params=pd, subcycle=16)
    u, its, ress, wall, counts = _timed_run(D, D.initial_state(ud0), 2,
                                            fields=f, params=pd, subcycle=16)
    say("12 adpm deck regime", outer_steps=2, subcycle=16,
        seconds=f"{wall:.4f}", outer_steps_per_s=f"{2 / wall:.4f}",
        inner_iters_total=int(its.sum()),
        max_residual=f"{float(ress.max()):.3e}",
        baseline_outer_steps_per_s=ADPM_DECK_BASELINE_OUTER_STEPS_PER_S)
    require(np.isfinite(u).all(), "ADPM deck regime: non-finite state")
    require(tuple(its.shape) == (2,) and tuple(ress.shape) == (2,),
            "subcycled run_steps must report per outer step")
    require(float(ress.max()) <= 1e-8,
            f"ADPM deck regime: residual {float(ress.max()):.3e} > 1e-8")
    _require_launched(counts, K.TRANSIENT_VARIANTS, "the ADPM deck regime")
    paths["adpm_deck"] = counts
    return paths



# ----------------------------------------------------------------------
# phase 13: the CLI drivers
# ----------------------------------------------------------------------
DRV_N, DRV_PIHNA_STEPS, DRV_ADPM_STEPS = 28, 120, 40
DRV_PIHNA_BASELINE_STEPS_PER_S = 18.87  # BASELINE_MEASURED.json
DRV_SOLID_BASELINE_S = 2.95
DRV_PHASES = ("mesh io", "initial conditions", "system setup", "solve",
              "csv output", "vtu output")
DRV_SOLID_PHASES = ("mesh io", "system setup", "newton solve",
                    "post process", "vtu output")
DRV_TRANSIENT = ("gather_interp_affine_f64", "rhs_affine_f64",
                 "apply_affine_f64", "restrict_f64")
DRV_SOLID = ("restrict_f32", "ell_matvec_f32")
# the solid bench leg (bench.py:290-341) as a deck; the tangent and the
# Krylov precision are the card's defaults (f32, mixed)
DRV_SOLID_DECK = """directory = simulation
input_GMSH = input.msh
loading_step = 0.5
BCs = ' 0 5 '
BC/0/displacement/0 = 0.0
BC/0/displacement/1 = 0.0
BC/0/displacement/2 = 0.0
BC/5/displacement/0 = NAN
BC/5/displacement/1 = NAN
BC/5/displacement/2 = -0.05
BCs/displacement_penalty = 1.0e6
materials = ' 0 '
material/0/Hyperelastic/Young = 1.0e3
material/0/Hyperelastic/Poisson = 0.3
solver/nonlinear/max_nonlinear_iterations = 20
solver/nonlinear/relative_residual_tolerance = 1e-6
solver/nonlinear/relative_step_tolerance = 1e-6
solver/nonlinear/reuse_tangent = true
"""


def _vtu_arrays(path):
    """{name: float array} of the Float64 DataArrays of one VTU file."""
    import re

    with open(path) as f:
        text = f.read()
    return {name: np.array(body.split(), dtype=np.float64)
            for name, body in re.findall(
                r'<DataArray type="Float64" Name="([^"]+)"[^>]*>\n(.*?)\n'
                r"        </DataArray>", text, re.S)}


def _perf_totals(stdout: str) -> dict:
    """Phase -> total seconds from the PerfLog report a driver prints."""
    tail = stdout.split(" Performance log:")[-1].splitlines()[2:]
    out = {}
    for line in tail:
        if line.startswith(" TOTAL"):
            break
        out[line[1:29].strip()] = float(line[37:49])
    return out


def _drive(case_dir, argv, dev):
    """cli.main(argv) in case_dir with the launch counts reset just before
    and read just after; the driver's stdout is kept, not shown."""
    import contextlib
    import io
    import os

    from rdcfes_tpu_torch import cli

    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(case_dir)
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        os.chdir(cwd)
    require(rc == 0, f"cli.main({argv}) returned {rc}")
    return wall, counts, buf.getvalue()


def _transient_artifacts(out_dir, base, outputs, species):
    """CSV header + one row per output, one VTU per output, a PVD with as
    many DataSets, the last frame's species finite and >= 0."""
    import os

    rows = open(os.path.join(out_dir, "output.csv")).read().splitlines()
    require(len(rows) == 1 + len(outputs) and rows[0].startswith('"TIME"'),
            f"{out_dir}: CSV has {len(rows)} lines")
    for t in outputs:
        require(os.path.exists(os.path.join(out_dir, f"{base}-{t}.vtu")),
                f"{out_dir}: no VTU at t = {t}")
    pvd = open(os.path.join(out_dir, base + ".pvd")).read()
    require(pvd.count("<DataSet") == len(outputs) and "</Collection>" in pvd,
            f"{out_dir}: PVD with {pvd.count('<DataSet')} DataSets")
    last = _vtu_arrays(os.path.join(out_dir, f"{base}-{outputs[-1]}.vtu"))
    for name in species:
        v = last[name]
        require(np.isfinite(v).all() and (v >= 0).all(),
                f"{out_dir}: {name} not finite and >= 0")
    return rows


def _say_driver(tag, wall, stdout, counts, variants, **kw):
    totals = _perf_totals(stdout)
    phases = DRV_SOLID_PHASES if tag == "solid" else DRV_PHASES
    say("13 " + tag, seconds=f"{wall:.4f}",
        **{k.replace(" ", "_") + "_s": f"{totals.get(k, 0.0):.4f}"
           for k in phases}, **kw)
    say(f"13 {tag} launches", **{k: counts[k] for k in variants})
    return totals


def phase_drivers(dev):
    """The CLI in process at full width (PIHNA and ADPM on 131,712 TET4,
    the solid on 110,592 HEX8), then as `python3 -m rdcfes_tpu_torch.cli`
    in a subprocess on a small case."""
    import os
    import shutil
    import sys
    import tempfile

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.mesh import gmsh
    from rdcfes_tpu_torch.systems import solid as solid_mod

    root = tempfile.mkdtemp(prefix="rdcfes_drivers_")
    total = {k: 0 for k in KERNELS}
    try:
        d = cases.make_pihna_case(os.path.join(root, "pihna"), n=DRV_N,
                                  n_steps=DRV_PIHNA_STEPS)
        wall, counts, out = _drive(d, ["-m", "pihna"], dev)
        outputs = list(range(0, DRV_PIHNA_STEPS + 1, 10))
        _transient_artifacts(os.path.join(d, "PIHNA_simulation"),
                             "Brain_Model", outputs,
                             ("n", "c", "h", "v", "a"))
        require(out.count(" ==== Step") == DRV_PIHNA_STEPS, "PIHNA banners")
        totals = _say_driver("pihna", wall, out, counts,
                             DRV_TRANSIENT + ("apply_affine_f32",),
                             steps=DRV_PIHNA_STEPS)
        say("13 pihna rate",
            solve_steps_per_s=f"{DRV_PIHNA_STEPS / totals['solve']:.4f}",
            baseline_steps_per_s=DRV_PIHNA_BASELINE_STEPS_PER_S)
        _require_launched(counts, DRV_TRANSIENT, "the PIHNA driver")
        require(counts["apply_affine_f32"] == 0,
                "the PIHNA driver runs f64: K3 f32 launched")
        for k in total:
            total[k] += counts.get(k, 0)

        d = cases.make_adpm_case(os.path.join(root, "adpm"), n=DRV_N,
                                 n_steps=DRV_ADPM_STEPS)
        # the case deck's taxis amplitude 1e3 is bench.py's deck regime,
        # which needs subcycle=16 (phase 12); the driver, as the
        # reference's, steps the full dt, where its f64 BiCGStab does not
        # converge at this width: run the taxis-active leg's amplitude 50
        # (bench.py:158-192) instead
        deck = open(os.path.join(d, "input.dat")).read()
        require(deck.count("0.999999e+3") == 2, "ADPM case deck changed")
        with open(os.path.join(d, "input.dat"), "w") as f:
            f.write(deck.replace("0.999999e+3", "50.0"))
        wall, counts, out = _drive(d, ["-m", "adpm"], dev)
        (res_dir,) = [e for e in os.listdir(d)
                      if os.path.isdir(os.path.join(d, e))]
        rows = _transient_artifacts(os.path.join(d, res_dir), "Brain_Model",
                                    list(range(0, DRV_ADPM_STEPS + 1, 20)),
                                    ("PrP", "A_b", "Tau"))
        require("CONCENTRATION__A_b__10" in rows[0]
                and "VOLUME__Tau__20" in rows[0], "ADPM CSV header")
        totals = _say_driver("adpm", wall, out, counts,
                             DRV_TRANSIENT + ("apply_affine_f32",),
                             steps=DRV_ADPM_STEPS)
        say("13 adpm rate",
            solve_steps_per_s=f"{DRV_ADPM_STEPS / totals['solve']:.4f}",
            baseline_steps_per_s=ADPM_BASELINE_STEPS_PER_S)
        _require_launched(counts, DRV_TRANSIENT, "the ADPM driver")
        require(counts["apply_affine_f32"] == 0,
                "the ADPM driver runs f64: K3 f32 launched")
        for k in total:
            total[k] += counts.get(k, 0)

        d = os.path.join(root, "solid")
        os.makedirs(d)
        gmsh.write(box_hex_mesh(SOLID_N, SOLID_N, SOLID_N),
                   os.path.join(d, "input.msh"))
        with open(os.path.join(d, "input.dat"), "w") as f:
            f.write(DRV_SOLID_DECK)
        results = []
        run_solver = solid_mod.SolidSystem.run_solver

        def recorded(self, x, pseudo_time):
            r = run_solver(self, x, pseudo_time)
            results.append(r)
            return r

        solid_mod.SolidSystem.run_solver = recorded
        try:
            wall, counts, out = _drive(d, ["-s"], dev)
        finally:
            solid_mod.SolidSystem.run_solver = run_solver
        require(len(results) == 2, f"{len(results)} load steps, not 2")
        for i, r in enumerate(results):
            rel = r.residual_norm / r.initial_residual_norm
            say("13 solid load step", step=i + 1, converged=r.converged,
                newton_iters=r.iters, linear_iters=r.linear_iters,
                residual=f"{r.residual_norm:.3e}", rel_residual=f"{rel:.3e}")
            require(r.converged, f"solid load step {i + 1} did not converge")
        last = _vtu_arrays(os.path.join(d, "simulation",
                                        "output4paraview-2.vtu"))
        require(len(last) == 18 and all(np.isfinite(v).all()
                                         for v in last.values()),
                "solid VTU fields not all finite")
        totals = _say_driver("solid", wall, out, counts, DRV_SOLID,
                             load_steps=2)
        say("13 solid rate",
            s_per_load_step=f"{totals['newton solve'] / 2:.4f}",
            baseline_s=DRV_SOLID_BASELINE_S)
        _require_launched(counts, DRV_SOLID, "the solid driver")
        for k in total:
            total[k] += counts.get(k, 0)

        d = cases.make_pihna_case(os.path.join(root, "module"), n=6,
                                  n_steps=3)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "rdcfes_tpu_torch.cli",
                            "-m", "pihna"], cwd=d, env=env,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        require(p.returncode == 0,
                "python3 -m rdcfes_tpu_torch.cli -m pihna exited "
                f"{p.returncode}: {p.stderr[-2000:]}")
        _transient_artifacts(os.path.join(d, "PIHNA_simulation"),
                             "Brain_Model", [0], ("n", "c", "h", "v", "a"))
        say("13 module", command="python3 -m rdcfes_tpu_torch.cli -m pihna",
            exit_code=p.returncode, seconds=f"{wall:.4f}",
            banners=p.stdout.count(" ==== Step"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10,11,12,13",
                    help="comma-separated phases to run (default: all)")
    phases = {int(x) for x in ap.parse_args(argv).phases.split(",")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = phase_device()
    if 1 in phases:
        phase_build()
    also = {}  # variant -> {shape label: row}, beside its first row
    kern = phase_kernels(dev, also) if 2 in phases else {}
    if 3 in phases:
        phase_oracle(dev)
    if 4 in phases:
        phase_paths(dev)
    paths = {"transient": phase_slice(dev) if 5 in phases else {}}
    S = (make_solid(SOLID_N, dev, SOLID_BENCH_OPTS, "f32")
         if phases & {6, 8} else None)
    solid_kern = phase_solid_kernels(dev, S) if 6 in phases else {}
    if 7 in phases:
        phase_solid_paths(dev)
    paths["solid"] = phase_solid_slice(dev, S) if 8 in phases else {}
    del S
    H = (make_system(box_hex_mesh(HEX_N, HEX_N, HEX_N, bounds=BRAIN), dev)
         if phases & {9, 12} else None)
    gen_kern = phase_generic_kernels(dev, H, also) if 9 in phases else {}
    if 10 in phases:
        fits, paths["calibration"] = phase_calibration(dev)
    if 11 in phases:
        phase_generic_paths(dev)
    if 12 in phases:
        paths.update(phase_generic_slice(dev, H))
    del H
    if 13 in phases:
        paths["drivers"] = phase_drivers(dev)
    rows = []
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    for name, (src, replaces) in KERNELS.items():
        # every path that ran, with its zeros
        by_path = {p: c.get(name, 0) for p, c in paths.items() if c}
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(by_path.values()) if by_path else None,
               "launches_by_path": by_path}
        first = (kern.get(name) or solid_kern.get(name)
                 or gen_kern.get(name) or {})
        row.update({k: first.get(k) for k in keys})
        if name in kern and name in solid_kern:
            also.setdefault(name, {})["solid assembly"] = solid_kern[name]
        if name in also:
            row["also"] = {tag: {k: r[k] for k in keys}
                           for tag, r in also[name].items()}
        rows.append(row)
    print(card, flush=True)  # again beside the results, for a cut log
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
