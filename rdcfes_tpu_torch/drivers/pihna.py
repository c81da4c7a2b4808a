"""PIHNA driver: 5-species glioma growth (the flow of
rdcfes_tpu.drivers.pihna; C++ reference src/pihna.C:18-96).

Flow: deck -> results dir -> Gmsh read + processed copy -> nodal ICs
(n, c, h, v, a) + elemental structure (HU, RT) -> time loop (rotate
history, linearized-CN solve, clamp >= 0) -> CSV volumes + VTU/PVD at the
output time points, and an optional checkpoint every `checkpoint/step`.

The steps between two events (an output or a checkpoint) go through one
`run_steps` call.  Not ported, each raising NotImplementedError before
the first step: AMR (an adaptation step `t % refinement_step == 0` in
1..time_step_number while `mesh/AMR/max_steps` > 0, ROADMAP queue 1 item
13), a checkpoint written after AMR (`amr_done` or `constraints`, item
13), `parallel/n_devices` > 1 (item 14), and meshes other than
single-type TET4 or HEX8 (item 13).
"""

from __future__ import annotations

import os

import torch

from ..io import dat, provenance
from ..io.csv_metrics import pihna_header, pihna_row
from ..io.getpot import Deck
from ..io.vtu import ParaviewWriter, elemental_to_nodal
from ..mesh import gmsh
from ..models.pihna import PIHNA_VARS, pihna_blocks
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import cuda_device
from .common import (PerfLog, make_rdc_system, maybe_profile,
                     output_time_points, step_banner)

_AMR = "ROADMAP queue 1 item 13 (mixed meshes and AMR)"


def load_params(deck: Deck) -> dict:
    """Deck key -> physics param mapping (src/pihna.C:182-234), including
    the necrosis/* -> /Kappa_k scaling (src/pihna.C:364-366)."""
    p = {}
    p["dt"] = deck("time_step", 1.0e-9)
    p["cells_min_capacity"] = deck("cells_min_capacity", 0.0)
    Kk = deck("cells_max_capacity", 1.0)
    p["cells_max_capacity"] = Kk
    p["cells_max_capacity_exponent"] = deck("cells_max_capacity/exponent", 1.0)
    p["cytokines_max_capacity"] = deck("cytokines_max_capacity", 1.0)
    p["necrosis_c"] = deck("necrosis/c", 0.0) / Kk
    p["necrosis_h"] = deck("necrosis/h", 0.0) / Kk
    p["necrosis_v"] = deck("necrosis/v", 0.0) / Kk
    p["diffuse_c"] = deck("diffuse/c", 0.0)
    p["taxis_c"] = deck("taxis/c", 0.0)
    p["diffuse_h"] = deck("diffuse/h", 0.0)
    p["taxis_h"] = deck("taxis/h", 0.0)
    p["produce_c"] = deck("produce/c", 0.0)
    p["switch_c2h"] = deck("switch/c/to/h", 0.0)
    p["switch_h2c"] = deck("switch/h/to/c", 0.0)
    p["switch_h2n"] = deck("switch/h/to/n", 0.0)
    p["diffuse_v"] = deck("diffuse/v", 0.0)
    p["taxis_v"] = deck("taxis/v", 0.0)
    p["produce_v"] = deck("produce/v", 0.0)
    p["secrete_a_c"] = deck("secrete/a/from/c", 0.0)
    p["secrete_a_h"] = deck("secrete/a/from/h", 0.0)
    p["uptake_a_v"] = deck("uptake/a/from/v", 0.0)
    p["decay_a"] = deck("decay/a", 0.0)
    return p


def load_ranges(deck: Deck) -> dict:
    r = {}
    for key, pkey in [
        ("range/active_tumor", "range_active_tumor"),
        ("range/necrotic", "range_necrotic"),
        ("range/vascularity", "range_vascularity"),
        ("range/total_cell", "range_total_cell"),
    ]:
        r[pkey + "_min"] = deck(key + "/min", 1.0e-12)
        r[pkey + "_max"] = deck(key + "/max", 1.0e12)
    return r


def run(deck_path: str = "input.dat", device=None) -> str:
    """Run the deck at `deck_path`; returns the results directory.  device
    None is the CUDA card (RuntimeError without one)."""
    dev = cuda_device() if device is None else torch.device(device)
    plog = PerfLog("pihna")
    deck = Deck(deck_path)

    input_gmsh = deck("input_GMSH", "input.msh")
    input_nodal = deck("input_nodal", "input.nodal")
    input_elem = deck("input_elemental", "input.elemental")
    n_steps = deck("time_step_number", 1)
    dt = deck("time_step", 1.0e-9)
    refinement_step = deck("refinement_step", 1 + n_steps)
    amr_max_steps = deck("mesh/AMR/max_steps", 0)
    if amr_max_steps > 0 and 0 < refinement_step <= n_steps:
        raise NotImplementedError(
            f"AMR at step {refinement_step} (refinement_step = "
            f"{refinement_step}, mesh/AMR/max_steps = {amr_max_steps}): "
            f"{_AMR}")
    # consumed as the reference consumes them; they only steer AMR
    for key, default in (("mesh/AMR/max_level", 3),
                         ("mesh/AMR/refine_percentage", 0.5),
                         ("mesh/AMR/coarsen_percentage", 0.5),
                         ("mesh/AMR/strategy", "bisection"),
                         ("mesh/skip_renumber_nodes_and_elements", True)):
        deck(key, default)
    DIR = provenance.prepare_results_dir(
        deck("directory", "") or None, deck_path, [input_nodal, input_elem]
    )
    out_gmsh = os.path.join(DIR, deck("output_GMSH", "output.msh"))
    out_pv = os.path.join(DIR, deck("output_PARAVIEW", "output4paraview"))
    out_csv = os.path.join(DIR, deck("output_CSV", "output.csv"))
    ckpt_step = deck("checkpoint/step", 0)
    ckpt_resume = deck("checkpoint/resume", "")
    otp = output_time_points(deck, n_steps)

    with plog.scope("mesh io"):
        mesh = gmsh.read(input_gmsh)
        print(mesh.print_info())
        gmsh.write(mesh, out_gmsh)

    with plog.scope("initial conditions"):
        u0 = dat.read_stream(input_nodal, mesh.n_nodes, 5)
        structure = dat.read_stream(input_elem, mesh.n_elems, 2)  # HU, RT

    params = load_params(deck)
    ranges = load_ranges(deck)
    if ckpt_resume:
        st, start_step, time_value, extra = load_checkpoint(ckpt_resume,
                                                            params)
        if "amr_done" in extra or "constraints" in extra:
            raise NotImplementedError(
                f"{ckpt_resume} was written after AMR: {_AMR}")

    with plog.scope("system setup"):
        system = make_rdc_system(mesh, 5, pihna_blocks, deck, device=dev)
        state = system.initial_state(u0)

    paraview = ParaviewWriter(mesh)
    # a resumed run in the same results dir appends to the CSV and the
    # PVD instead of truncating what was written before
    resuming = bool(ckpt_resume) and os.path.exists(out_csv)
    paraview.open_pvd(out_pv, resume=resuming)
    csv = open(out_csv, "a" if resuming else "w")
    if not resuming:
        pihna_header(csv)

    hu_nodal = elemental_to_nodal(mesh, structure[:, 0])
    rt_nodal = elemental_to_nodal(mesh, structure[:, 1])

    def save(t: int, time_value: float):
        u = state["u"].cpu().numpy()
        with plog.scope("csv output"):
            pihna_row(csv, mesh, u, time_value, {**params, **ranges})
        with plog.scope("vtu output"):
            fields = [(name, u[:, i]) for i, name in enumerate(PIHNA_VARS)]
            fields += [("HU", hu_nodal), ("RT", rt_nodal)]
            paraview.update_pvd(fields, t)

    if ckpt_resume:
        state = system.scatter_state(st)
        print(f"resumed from {ckpt_resume} at step {start_step}")
    else:
        start_step, time_value = 0, 0.0
        save(0, 0.0)

    def next_event(t: int) -> int:
        nxt = n_steps
        if ckpt_step:
            nxt = min(nxt, ((t // ckpt_step) + 1) * ckpt_step)
        future = [s for s in otp if s > t]
        if future:
            nxt = min(nxt, min(future))
        return nxt

    with maybe_profile():
        t = start_step
        while t < n_steps:
            seg = next_event(t) - t
            if seg > 1:
                with plog.scope("solve"):
                    state, _its, _res = system.run_steps(state, seg,
                                                         params=params)
                for j in range(seg):
                    time_value += dt
                    step_banner(t + 1 + j, n_steps, time_value)
                t += seg
            else:
                t += 1
                time_value += dt
                step_banner(t, n_steps, time_value)
                with plog.scope("solve"):
                    state, _its, _res = system.step(state, params=params)
            if ckpt_step and t % ckpt_step == 0:
                with plog.scope("checkpoint"):
                    save_checkpoint(os.path.join(DIR, "checkpoint.npz"),
                                    system.gather_state(state), t,
                                    time_value, params)
            if t in otp:
                save(t, time_value)

    csv.close()
    paraview.close_pvd()
    deck.warn_unused()
    plog.report()
    return DIR
