"""RIPF driver: radiation-induced pulmonary fibrosis (the flow of
rdcfes_tpu.drivers.ripf; C++ reference src/ripf.C:13-96).

Three coupled field groups, as in the reference: the implicit RIPF system
(HU, cc, fb), the finite-difference time-derivative (TD) fields, and the
RT dose fields (broad, focus, total).  Per step (src/ripf.C:69-93 and
check_solution :675-775):

  1. linearized-CN solve of (HU, cc, fb);
  2. clamp: HU to [HU/min, HU/max], cc and fb >= 0;
  3. TD fields = (clamped - previous RAW solution) / dt: the reference
     keeps the PRE-clamp solver output as "previous" (src/ripf.C:770);
  4. accumulate the fractionated RT dose by simulation day and resolve
     fb/lambda/RT/r and fb/omicro/RT/r: a deck value of 0 falls back to
     the maximum total dose, truncated to an integer (src/ripf.C:397-403,
     :772).

The steps between two events (an output, a checkpoint, or the step after
which the maximum dose would be <= 0, where the reference aborts) go
through one `run_steps` call, one step or many: its `field_update` hook
rebuilds the TD and dose fields at the quadrature points before each step
from the carried state, on the device, and the resolved rates ride
`scalar_traj`.  Step t+1+j sees the values resolved at step t+j.  The
time of step k is dt * k everywhere (dose, banners, CSV, checkpoints), as
on the reference's segment path; the reference's per-step path (its
one-step segments) sums dt instead, so at a day boundary that the sum
misses (dt = 0.1: ten additions give 0.9999999999999999) it reads the
previous day's dose there.  The field rebuild goes through the system's
own kernels, once per element block: K1 on TET4, K8 on HEX8, PRISM6,
PYRAMID5 and TET10; on a MixedMesh each field is a tuple of one entry
per block.  `parallel/n_devices` = D > 1 runs the mesh, single-type or
mixed, on D shards (parallel.halo.HaloShardedSystem): the dose goes to
the shards once (scatter_nodal), the field rebuild ghost-fills each
shard's nodal TD and dose slab and runs the same kernels on each of the
shard's element blocks, and the TD fields at a segment's end come from
the gathered state.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import dat, provenance
from ..io.csv_metrics import ripf_row
from ..io.getpot import Deck
from ..io.vtu import ParaviewWriter
from ..mesh import gmsh
from ..models.ripf import RIPF_VARS, ripf_blocks, rt_dose_schedule
from ..parallel import HaloShardedSystem
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import cuda_device
from .common import (PerfLog, make_rdc_system, maybe_profile,
                     output_time_points, step_banner)

_RESOLVED = ("lambda_RT_r", "omicro_RT_r")


def load_params(deck: Deck) -> dict:
    """Deck key -> physics params with the reference's range checks
    (src/ripf.C:171-250: libmesh_error() on out-of-range values), raised
    as ValueError."""
    def req(name, default, check):
        v = deck(name, default)
        if not check(v):
            raise ValueError(f"input parameter out of range: {name} = {v} ")
        return v

    nonneg = lambda v: v >= 0.0
    p = {"dt": deck("time_step", 1.0e-9)}
    p["volfr_stroma"] = deck("volume_fraction/stroma", 0.0)
    p["volfr_parenchyma"] = deck("volume_fraction/parenchyma", 0.0)
    p["volfr_exponent"] = req("volume_fraction/exponent", 1.0, nonneg)
    p["volfr_min_vacant"] = deck("volume_fraction/min_vacant", 1.0e-12)
    deck("volume_fraction/max_vacant", 1.0 - p["volfr_min_vacant"])
    p["phi_cc_build"] = req("HU/phi/cc/build", 0.0, nonneg)
    p["phi_cc_decay"] = req("HU/phi/cc/decay", 0.0, lambda v: v <= 0.0)
    p["phi_cc_rate"] = req("HU/phi/cc/rate", 0.0, nonneg)
    p["phi_fb_build"] = req("HU/phi/fb/build", 0.0, nonneg)
    p["phi_fb_decay"] = req("HU/phi/fb/decay", 0.0, lambda v: v <= 0.0)
    p["phi_fb_rate"] = req("HU/phi/fb/rate", 0.0, nonneg)
    p["phi_tolerance"] = req("HU/phi/tolerance", 0.0, nonneg)
    p["cc_kappa"] = req("cc/kappa", 0.0, nonneg)
    p["cc_kappa_RT_c"] = req("cc/kappa/RT/c", 0.0, nonneg)
    p["cc_delta"] = req("cc/delta", 0.0, nonneg)
    p["cc_delta_RT_a"] = req("cc/delta/RT/a", 0.0, lambda v: v > 0.0)
    p["cc_delta_RT_b"] = req("cc/delta/RT/b", 0.0, lambda v: v > 0.0)
    p["fb_lambda"] = req("fb/lambda", 0.0, nonneg)
    p["_fb_lambda_RT_r"] = req("fb/lambda/RT/r", 0.0, nonneg)
    p["lambda_HU_r"] = req("fb/lambda/HU/r", -1.0, lambda v: v < 0.0)
    p["fb_omicro"] = req("fb/omicro", 0.0, nonneg)
    p["_fb_omicro_RT_r"] = req("fb/omicro/RT/r", 0.0, nonneg)
    p["omicro_fb_b"] = req("fb/omicro/fb/b", 0.0, lambda v: 0.0 <= v <= 1.0)
    p["fb_omega"] = req("fb/omega", 0.0, nonneg)
    p["fb_diffusion"] = req("fb/diffusion", 0.0, nonneg)
    p["fb_haptotaxis"] = req("fb/haptotaxis", 0.0, nonneg)
    p["fb_radiotaxis"] = req("fb/radiotaxis", 0.0, nonneg)
    return p


def block_qp_fields(ops, blk, geom, nodal: torch.Tensor) -> dict:
    """One element block's fields from nodal (cc TD, fb TD, total dose)
    (3, N) on its device: their values at the quadrature points and the
    unit gradient of the dose (zero where the gradient is), through the
    block's gather + interpolation kernel (K1 on TET4, whose one gradient
    per element is what interpolate_at_qp gives an affine element,
    expanded over Q; K8 on the other types, per q)."""
    if blk.affine:
        vals, g1 = ops.gather_interp_affine(nodal, blk.conn_T, blk.phi,
                                            geom.dphi)
        g = g1[2][None]                                      # (1, 3, E)
    else:
        vals, gq = ops.gather_interp_generic(nodal, blk.conn_T, blk.phi,
                                             geom.dphi)
        g = gq[2]                                            # (Q, 3, E)
    norm = torch.sqrt(torch.sum(g * g, dim=-2, keepdim=True))
    unit = torch.where(norm > 0.0,
                       g / torch.where(norm == 0.0, 1.0, norm), 0.0)
    return {"cc_dtime": vals[0], "fb_dtime": vals[1], "RT": vals[2],
            "RT_grad_unit": unit.expand(vals.shape[1], 3, vals.shape[2])}


def qp_fields(system, nodal: torch.Tensor) -> dict:
    """The model's fields from nodal (3, N) on the system's device, block
    by block (block_qp_fields).  On a MixedMesh every field is a tuple of
    one entry per block."""
    parts = [block_qp_fields(system.ops, blk, geom, nodal)
             for blk, geom in zip(system.blocks, system.geoms)]
    if system.mesh.elem_type != "MIXED":
        return parts[0]
    return {k: tuple(p[k] for p in parts) for k in parts[0]}


def sharded_qp_fields(system, nodal) -> dict:
    """The model's fields on the shards of a HaloShardedSystem from the
    per-shard nodal slabs (3, No_max): each slab ghost-filled, then
    block_qp_fields on each of the shard's element blocks.  Every field is
    a list of one entry per shard, each a tuple of one entry per block of
    the mesh (None where the shard holds none of its elements)."""
    out = {}
    for sh, x in zip(system.shards, system.ghost_fill(nodal)):
        parts = {bi: block_qp_fields(system.ops, blk, geom, x)
                 for bi, blk, geom in sh.parts}
        for k in ("cc_dtime", "fb_dtime", "RT", "RT_grad_unit"):
            out.setdefault(k, []).append(tuple(
                parts[bi][k] if bi in parts else None
                for bi in range(system.n_blocks)))
    return out


def run(deck_path: str = "input.dat", device=None) -> str:
    """Run the deck at `deck_path`; returns the results directory.  device
    None is the CUDA card (RuntimeError without one)."""
    dev = cuda_device() if device is None else torch.device(device)
    plog = PerfLog("ripf")
    deck = Deck(deck_path)

    input_gmsh = deck("input_GMSH", "input.msh")
    input_nodal = deck("input_nodal", "input.nodal")
    input_rt = deck("input_nodal_RT", "input.nodal~RT")
    DIR = provenance.prepare_results_dir(
        deck("directory", "") or None, deck_path, [input_nodal, input_rt]
    )
    out_gmsh = os.path.join(DIR, deck("output_GMSH", "output.msh"))
    out_pv = os.path.join(DIR, deck("output_PARAVIEW", "output4paraview"))
    out_csv = os.path.join(DIR, deck("output_CSV", "output.csv"))

    n_steps = deck("time_step_number", 1)
    dt = deck("time_step", 1.0e-9)
    ckpt_step = deck("checkpoint/step", 0)
    ckpt_resume = deck("checkpoint/resume", "")
    deck("mesh/skip_renumber_nodes_and_elements", True)
    otp = output_time_points(deck, n_steps)

    HU_min = deck("HU/min", -1000.0)
    HU_max = deck("HU/max", 1000.0)
    broad_frac = deck("RT_dose/broad/fractions", 1)
    focus_frac = deck("RT_dose/focus/fractions", 1)
    ranges = {
        "range_cc_HU_min": deck("range_cc/HU/min", HU_min),
        "range_cc_HU_max": deck("range_cc/HU/max", HU_max),
        "range_cc_min": deck("range_cc/min", 1.0e-9),
        "range_fb_HU_min": deck("range_fb/HU/min", HU_min),
        "range_fb_HU_max": deck("range_fb/HU/max", HU_max),
        "range_fb_min": deck("range_fb/min", 1.0e-9),
    }
    params = load_params(deck)

    with plog.scope("mesh io"):
        mesh = gmsh.read(input_gmsh)
        print(mesh.print_info())
        gmsh.write(mesh, out_gmsh)

    with plog.scope("initial conditions"):
        u0 = dat.read_stream(input_nodal, mesh.n_nodes, 3)
        rt = dat.read_stream(input_rt, mesh.n_nodes, 2)  # broad, focus

    def clamp(u):
        # u (V, N): HU to the deck's bounds, cc and fb non-negative
        # (src/ripf.C:718-721)
        return torch.cat([torch.clamp(u[:1], HU_min, HU_max),
                          torch.clamp(u[1:], min=0.0)])

    with plog.scope("system setup"):
        system = make_rdc_system(mesh, 3, ripf_blocks, deck, clamp=clamp,
                                 device=dev)
        state = system.initial_state(u0)

    sharded = isinstance(system, HaloShardedSystem)
    rt_host = torch.as_tensor(rt)
    # the nodal doses where the state lives: (N, 2), or (2, No_max) slabs
    rt_dev = (system.scatter_nodal(rt) if sharded
              else torch.as_tensor(rt, device=dev))

    def dose(time_value) -> np.ndarray:
        """The total dose (N,) at `time_value`, on the host."""
        return rt_dose_schedule(rt_host[:, 0], rt_host[:, 1], time_value,
                                broad_frac, focus_frac).numpy()

    # --- check_solution's state: TD fields and total dose ----------------
    # before the loop, as the reference (src/ripf.C:50-53)
    td = (system.gather(state["u"]) - u0) / dt
    rt_total = None

    def resolve(t: int) -> None:
        """The total dose at step t; the reference aborts when its
        maximum is <= 0."""
        nonlocal rt_total
        rt_total = dose(dt * t)
        if rt_total.max() <= 0.0:
            raise RuntimeError(
                "maximum total RT dose <= 0 (reference aborts here)")

    resolve(0)

    paraview = ParaviewWriter(mesh)
    # a resumed run in the same results dir appends instead of truncating
    resuming = bool(ckpt_resume) and os.path.exists(out_csv)
    paraview.open_pvd(out_pv, resume=resuming)
    csv = open(out_csv, "a" if resuming else "w")  # no header

    def save(t: int):
        u = system.gather(state["u"])
        with plog.scope("csv output"):
            ripf_row(csv, mesh, u, dt * t, ranges)
        with plog.scope("vtu output"):
            out = [(name, u[:, i]) for i, name in enumerate(RIPF_VARS)]
            out += [
                ("HU_TimeDeriv", td[:, 0]),
                ("cc_TimeDeriv", td[:, 1]),
                ("fb_TimeDeriv", td[:, 2]),
                ("RT_dose/broad", rt[:, 0]),
                ("RT_dose/focus", rt[:, 1]),
                ("RT_dose/total", rt_total),
            ]
            paraview.update_pvd(
                out, t, processor_id=getattr(system, "processor_id", None))

    step_params = {k: v for k, v in params.items()
                   if not k.startswith("_") and k not in _RESOLVED}
    start_step = 0
    if ckpt_resume:
        st, start_step, _time, extra = load_checkpoint(ckpt_resume,
                                                       step_params)
        state = system.scatter_state(st)
        td = extra["td"]
        resolve(start_step)
        print(f"resumed from {ckpt_resume} at step {start_step}")
    else:
        save(0)

    # the resolved rates of every step, from the dose at dt * step: a deck
    # value of 0 falls back to the maximum dose truncated to an integer
    rtmax_traj = np.array([dose(dt * k).max() for k in range(n_steps + 1)])
    resolved_traj = {key: np.full(n_steps + 1, params["_fb_" + key])
                     if params["_fb_" + key]
                     else rtmax_traj.astype(np.int64).astype(np.float64)
                     for key in _RESOLVED}
    # the reference aborts at the check AFTER the step where the maximum
    # dose reaches zero: segments end there, so the artifacts match
    abort_t = next((k for k in range(start_step + 1, n_steps + 1)
                    if rtmax_traj[k] <= 0.0), None)

    def field_update(st, prev_raw2, tr):
        """The fields of the next step from the carried state: prev_raw2
        is the raw solution of two steps back, the value check_solution
        had stored before the previous step."""
        td_d = (st["u"] - prev_raw2) / dt
        rt_tot = rt_dose_schedule(rt_dev[:, 0], rt_dev[:, 1], tr["RT_time"],
                                  broad_frac, focus_frac)
        nodal = torch.stack([td_d[:, 1], td_d[:, 2], rt_tot])
        return qp_fields(system, nodal), st["u_raw"]

    def sharded_field_update(st, prev_raw2, tr):
        """field_update on the shards' (V, No_max) slabs."""
        nodal = [torch.stack([(u[1] - pr[1]) / dt, (u[2] - pr[2]) / dt,
                              rt_dose_schedule(r[0], r[1], tr["RT_time"],
                                               broad_frac, focus_frac)])
                 for u, pr, r in zip(st["u"], prev_raw2, rt_dev)]
        return sharded_qp_fields(system, nodal), st["u_raw"]

    def next_event(tc: int) -> int:
        nxt = n_steps if abort_t is None else min(n_steps, abort_t)
        if ckpt_step:
            nxt = min(nxt, ((tc // ckpt_step) + 1) * ckpt_step)
        future = [s for s in otp if s > tc]
        if future:
            nxt = min(nxt, min(future))
        return nxt

    # raw_{t-1}: the initial raw solution, or after a resume rebuilt from
    # the TD identity; then carried from segment to segment
    aux = u0 if not ckpt_resume else system.gather(state["u"]) - dt * td
    aux = (system.scatter_nodal(aux) if sharded
           else torch.as_tensor(aux, device=dev))
    update = sharded_field_update if sharded else field_update
    with maybe_profile():
        t = start_step
        while t < n_steps:
            seg = next_event(t) - t
            idx = np.arange(t, t + seg)
            straj = {key: v[idx] for key, v in resolved_traj.items()}
            straj["RT_time"] = dt * idx
            with plog.scope("solve"):
                state, _its, _res, aux = system.run_steps(
                    state, seg, params=step_params, scalar_traj=straj,
                    field_update=update, field_aux=aux)
            for k in range(t + 1, t + seg + 1):
                step_banner(k, n_steps, dt * k)
            t += seg
            # check_solution at the segment's end
            td = (system.gather(state["u"]) - system.gather(aux)) / dt
            resolve(t)
            if ckpt_step and t % ckpt_step == 0:
                with plog.scope("checkpoint"):
                    save_checkpoint(os.path.join(DIR, "checkpoint.npz"),
                                    system.gather_state(state), t, dt * t,
                                    step_params, td=td,
                                    prev_raw=system.gather(state["u_raw"]))
            if t in otp:
                save(t)

    csv.close()
    paraview.close_pvd()
    deck.warn_unused()
    plog.report()
    return DIR
