"""PIHNA driver: 5-species glioma growth (the flow of
rdcfes_tpu.drivers.pihna; C++ reference src/pihna.C:18-96).

Flow: deck -> results dir -> Gmsh read + processed copy -> nodal ICs
(n, c, h, v, a) + elemental structure (HU, RT) -> time loop (rotate
history, linearized-CN solve, clamp >= 0) -> CSV volumes + VTU/PVD at the
output time points, and an optional checkpoint every `checkpoint/step`.
The steps between two events (an output, a checkpoint or an AMR step)
go through one `run_steps` call.

AMR (src/pihna.C:805-840: KellyErrorEstimator +
flag_elements_by_mean_stddev + refine_and_coarsen_elements + reinit): at
every `refinement_step`, up to `mesh/AMR/max_steps` times, the state
comes off the device once, the Kelly indicator is summed over the five
species, elements are flagged by the mean-stddev rule
(`mesh/AMR/refine_percentage`, `mesh/AMR/coarsen_percentage`), and the
mesh is adapted on the host: on TET4 by `mesh/AMR/strategy` "bisection"
(the default: conforming bisection with coarsening, mesh/adapt.py) or
"1to8" (selective 1:8 with hanging-node constraints and coarsening,
mesh/constrain.py), both capped by `mesh/AMR/max_level`; on HEX8 by
uniform 1:8 when anything is flagged (mesh/refine.refine_flagged); on
TET10 by bisection of the corner skeleton with the exact quadratic
transfer (mesh/adapt_ext.Tet10Adaptive; "1to8" warns and bisects, as the
reference does); on a MixedMesh by 1:8 of its TET4 block with hanging
nodes against the other blocks, which do not refine (mesh/adapt_ext.
MixedConstrained, the Kelly indicator on the TET4 block only).  The
structure (HU, RT) is carried to the new elements, the state is
prolonged, and the system is rebuilt on the new mesh (with its
hanging-node constraints).  A checkpoint written after AMR holds the
refined mesh (`checkpoint_mesh.msh` beside it), the structure, `amr_done`
and the constraints, and a resume goes on from that mesh.

A MixedMesh (HEX8, PYRAMID5, PRISM6 and TET4 blocks) runs through
systems.mixed.MixedTransientRDCSystem in mixed precision, as the
reference's driver does; a TET10 mesh through TransientRDCSystem's
generic path.  The structure is an elemental field in the global
(block-concatenated) element order.

`parallel/n_devices` = D > 1 runs the mesh, single-type or mixed, on D
shards (parallel.halo.HaloShardedSystem, drivers/common.make_rdc_system):
the VTU gets each element's shard as processor_id, the state comes off
the shards (gather_state) for the CSV, AMR and the checkpoint, and goes
back (scatter_state) onto the system rebuilt on the adapted mesh (with a
MixedMesh's hanging-node constraints) or after a resume.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fem.amr import flag_by_mean_stddev, kelly_error_indicator
from ..io import dat, provenance
from ..io.csv_metrics import pihna_header, pihna_row
from ..io.getpot import Deck
from ..io.vtu import ParaviewWriter, elemental_to_nodal
from ..mesh import (AdaptiveMesh, ConstrainedMesh, MixedConstrained,
                    Tet10Adaptive, adapt_flagged, gmsh, kelly_mixed,
                    refine_flagged)
from ..models.pihna import PIHNA_VARS, pihna_blocks
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import cuda_device
from .common import (PerfLog, make_rdc_system, maybe_profile,
                     output_time_points, step_banner)


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
    amr_max_level = deck("mesh/AMR/max_level", 3)
    amr_refine_frac = deck("mesh/AMR/refine_percentage", 0.5)
    amr_coarsen_frac = deck("mesh/AMR/coarsen_percentage", 0.5)
    amr_strategy = str(deck("mesh/AMR/strategy", "bisection"))
    deck("mesh/skip_renumber_nodes_and_elements", True)
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

    def _amr_state(m):
        """(bisection forest, constrained 1:8 mesh), one of them live:
        the one the deck's strategy picks on TET4, the skeleton forest
        on TET10, the TET4 block's constrained 1:8 on a MixedMesh;
        neither on HEX8 (uniform refinement)."""
        if m.elem_type == "TET10":
            if amr_strategy == "1to8":
                deck.warn("mesh/AMR/strategy = 1to8 is not honored on "
                          "TET10 meshes (quadratic hanging-node "
                          "constraints are out of scope); refining by "
                          "skeleton bisection instead")
            return Tet10Adaptive.from_mesh(m), None
        if m.elem_type == "MIXED":
            return None, MixedConstrained.from_mesh(m)
        if m.elem_type != "TET4":
            return None, None
        if amr_strategy == "1to8":
            return None, ConstrainedMesh(m)
        return AdaptiveMesh(m), None

    amr_done = 0
    sys_kw = {}
    resume_msg = None
    if ckpt_resume:
        st, start_step, time_value, extra = load_checkpoint(ckpt_resume,
                                                            params)
        ck_mesh = os.path.join(os.path.dirname(ckpt_resume),
                               "checkpoint_mesh.msh")
        if "amr_done" in extra and os.path.exists(ck_mesh):
            # written after AMR: the state lives on the refined mesh saved
            # beside it, with its structure and hanging-node constraints
            mesh = gmsh.read(ck_mesh)
            amr_done = int(extra["amr_done"])
            structure = extra["structure"]
            if "constraints" in extra and len(extra["constraints"]):
                sys_kw["constraints"] = np.asarray(extra["constraints"])
            resume_msg = f"resumed on AMR mesh ({mesh.n_elems} elements)"
    amesh, cmesh = _amr_state(mesh)
    if cmesh is not None and "constraints" in sys_kw:
        # the 1to8 hanging set is restored (the bisection forest, and
        # the 1:8 one, are not: pre-checkpoint refinements cannot
        # coarsen)
        cmesh.hanging = {(int(a), int(b)): int(h)
                         for h, a, b in sys_kw["constraints"]}

    with plog.scope("system setup"):
        system = make_rdc_system(mesh, 5, pihna_blocks, deck, device=dev,
                                 **sys_kw)
        state = system.initial_state(u0) if not ckpt_resume else None

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
        u = system.gather(state["u"])
        with plog.scope("csv output"):
            pihna_row(csv, mesh, u, time_value, {**params, **ranges})
        with plog.scope("vtu output"):
            fields = [(name, u[:, i]) for i, name in enumerate(PIHNA_VARS)]
            fields += [("HU", hu_nodal), ("RT", rt_nodal)]
            paraview.update_pvd(
                fields, t, processor_id=getattr(system, "processor_id",
                                                None))

    if ckpt_resume:
        if resume_msg:
            print(resume_msg)
        state = system.scatter_state(st)
        print(f"resumed from {ckpt_resume} at step {start_step}")
    else:
        start_step, time_value = 0, 0.0
        save(0, 0.0)

    def next_event(t: int) -> int:
        nxt = n_steps
        if refinement_step > 0 and amr_done < amr_max_steps:
            nxt = min(nxt, ((t // refinement_step) + 1) * refinement_step)
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
            if (refinement_step > 0 and t % refinement_step == 0
                    and amr_done < amr_max_steps):
                amr_done += 1
                with plog.scope("amr"):
                    gstate = system.gather_state(state)  # off the device
                    kelly = (kelly_mixed if mesh.elem_type == "MIXED"
                             else kelly_error_indicator)
                    eta = kelly(mesh, gstate["u"], range(5))
                    flags, coarsen = flag_by_mean_stddev(
                        eta, amr_refine_frac, amr_coarsen_frac)
                    if cmesh is not None:
                        r = cmesh.refine_and_coarsen(
                            flags, coarsen, max_level=amr_max_level)
                    elif amesh is not None:
                        r = adapt_flagged(amesh, flags, coarsen,
                                          max_level=amr_max_level)
                    else:
                        r = refine_flagged(mesh, flags)
                    if r is None:
                        print(f"AMR step {t}: nothing flagged, mesh "
                              f"unchanged")
                    else:
                        sys_kw = {}
                        if cmesh is not None:
                            cmesh = r.constrained
                            mesh = cmesh.mesh
                            cons = cmesh.constraints
                            structure = r.transfer_elemental(structure)
                            if len(cons):
                                sys_kw["constraints"] = cons
                            print(f"AMR step {t}: adapted to "
                                  f"{mesh.n_elems} elements ({len(cons)} "
                                  f"hanging nodes)")
                        else:
                            mesh = r.mesh
                            if amesh is not None:
                                amesh = r.adaptive
                            structure = r.restrict_elemental(structure)
                            print(f"AMR step {t}: adapted to "
                                  f"{mesh.n_elems} elements")
                        hu_nodal = elemental_to_nodal(mesh, structure[:, 0])
                        rt_nodal = elemental_to_nodal(mesh, structure[:, 1])
                        system = make_rdc_system(mesh, 5, pihna_blocks, deck,
                                                 device=dev, **sys_kw)
                        state = system.scatter_state(
                            {k: r.prolong(v) for k, v in gstate.items()})
                        paraview.mesh = mesh
            if ckpt_step and t % ckpt_step == 0:
                with plog.scope("checkpoint"):
                    extras = {}
                    if amr_done:
                        gmsh.write(mesh, os.path.join(DIR,
                                                      "checkpoint_mesh.msh"))
                        extras = {"structure": structure,
                                  "amr_done": np.asarray(amr_done)}
                        if cmesh is not None and len(cmesh.constraints):
                            # the refined mesh is nonconforming without
                            # its hanging-node constraints
                            extras["constraints"] = cmesh.constraints
                    save_checkpoint(os.path.join(DIR, "checkpoint.npz"),
                                    system.gather_state(state), t,
                                    time_value, params, **extras)
            if t in otp:
                save(t, time_value)

    csv.close()
    paraview.close_pvd()
    deck.warn_unused()
    plog.report()
    return DIR
