#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (rdcfes_tpu_torch) on one NVIDIA GPU, and
check it: the PIHNA transient step (phases 2-5) and the hyperelastic solid
load step (phases 6-8).

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases 0,1,2        # device, build, kernels
    python3 chip_smoke.py --phases 0,1,6,7,8    # the solid slice

Phases, one output line each (any failure raises, exit code != 0):
  0 device  the CUDA device (never the CPU) and nvidia-smi's name and
            power limit of the card
  1 build   compile csrc/*.cu with nvcc (sm_90a), one process per source,
            seconds taken
  2 kernels each transient kernel against its plain PyTorch version on
            the bench mesh and initial state (f64 within 1e-13, f32 within
            1e-5, relative to the largest plain value); median CUDA-event
            time of 20 calls for the kernel, the plain version and, where
            one exists, one library call computing the same function
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
from rdcfes_tpu_torch.fem.assembly import ell_structure
from rdcfes_tpu_torch.fem.bcsr import to_ell
from rdcfes_tpu_torch.fem.weakform import diffusion_presum
from rdcfes_tpu_torch.mesh import box_hex_mesh, box_tet_mesh
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
}
BENCH_STEPS = 120
# NVIDIA H100 SXM data sheet: HBM3 rate; dense f32 and f64 rates outside
# the tensor cores (the kernels here use the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F32: 67e12, F64: 34e12}
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
    N, E = mesh.n_nodes, mesh.n_elems
    Kc, Q = s.conn_T.shape[0], s.JxW.shape[0]
    fe = flat64.reshape(V, Kc, E)
    nC, nD, nE = len(st64.idxC), len(st64.idxD), len(st64.idxE)
    apply_flops = 2.0 * E * Kc * (V * (Q + 3) + nC * Q + 3 * nD * Q + 3 * nE)
    conn_flat = s.conn_T.reshape(-1).long()
    live = int((s.node_gather < Kc * E).sum())
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
        "restrict_f32": dict(
            kern=lambda: K.restrict(flat32, s.node_gather),
            plain=lambda: K.restrict_plain(flat32, s.node_gather), tol=1e-5,
            library=lambda: torch.zeros((V, N), dtype=F32, device=dev
                                        ).index_add_(1, conn_flat, flat32),
            n_bytes=nbytes(flat32, s.node_gather) + V * N * 4,
            flops=float(V * live), dtype=F32),
        "restrict_f64": dict(
            kern=lambda: K.restrict(flat64, s.node_gather),
            plain=lambda: K.restrict_plain(flat64, s.node_gather), tol=1e-13,
            library=lambda: torch.zeros((V, N), dtype=F64, device=dev
                                        ).index_add_(1, conn_flat, flat64),
            n_bytes=nbytes(flat64, s.node_gather) + V * N * 8,
            flops=float(V * live)),
    }
    results = {name: measure("2 kernel", name, **c)
               for name, c in cases.items()}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8",
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
    paths = {"transient": phase_slice(dev) if 5 in phases else {}}
    S = (make_solid(SOLID_N, dev, SOLID_BENCH_OPTS, "f32")
         if phases & {6, 8} else None)
    solid_kern = phase_solid_kernels(dev, S) if 6 in phases else {}
    if 7 in phases:
        phase_solid_paths(dev)
    paths["solid"] = phase_solid_slice(dev, S) if 8 in phases else {}
    rows = []
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    for name, (src, replaces) in KERNELS.items():
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(by_path.values()) if by_path else None,
               "launches_by_path": by_path}
        first = kern.get(name) or solid_kern.get(name) or {}
        row.update({k: first.get(k) for k in keys})
        if name in kern and name in solid_kern:
            row["solid_assembly_shapes"] = {
                k: solid_kern[name][k] for k in keys}
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
