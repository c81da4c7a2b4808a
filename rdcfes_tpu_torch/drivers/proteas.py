"""PROTEAS driver: radiotherapy tumour response (the flow of
rdcfes_tpu.drivers.proteas; C++ reference src/proteas.C:17-91).

The only driver that takes its deck path from the CLI (`input=<file>`,
src/main.C:22-36).  Flow: deck -> results dir -> Gmsh read -> nodal ICs
(hos, tum, nec, vsc, oed) and nodal AUX (HU, RTD), both through the
comment-tolerant reader -> time loop -> VTU/PVD, and an optional
checkpoint every `checkpoint/step`.  The reference opens a CSV and never
writes a row (src/proteas.C:53-55 has no save_solution); so does this
driver.

The dose at the quadrature points is built once on the host, as a (Q, E)
field (a tuple of one (Q_b, E_b) field per block on a MixedMesh): the
interpolation of the AUX file's RTD column through the element's shape
functions by default, or, with the deck key `proteas/aux_sampling =
reference`, the C++ reference's phi_1(qp) * HU(local node 1)
(src/proteas.C:479-482) on every block.  The steps between two events
(an output or a checkpoint) go through one `run_steps` call, one step or
many; the time of step k is dt * k.  It runs on TET4, HEX8, TET10 and
mixed meshes.  `parallel/n_devices` = D > 1 runs the mesh on D shards
(parallel.halo.HaloShardedSystem): the RTD at the quadrature points goes
to the shards through shard_elem_field (on a MixedMesh per shard and
block), and the VTU gets each element's shard as processor_id.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fem.elements import tabulate
from ..io import dat, provenance
from ..io.getpot import Deck
from ..io.vtu import ParaviewWriter
from ..mesh import gmsh
from ..mesh.core import element_blocks
from ..models.proteas import PROTEAS_VARS, proteas_blocks
from ..parallel import HaloShardedSystem
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import cuda_device
from .common import (PerfLog, make_rdc_system, maybe_profile,
                     output_time_points, step_banner)

_PARAM_KEYS = [
    ("cells/total_capacity", "cells_total_capacity"),
    ("radiotherapy/max_dosage", "radiotherapy_max_dosage"),
    ("host/proliferation", "host_proliferation"),
    ("host/vsc_threshold", "host_vsc_threshold"),
    ("host/RT_death_rate", "host_RT_death_rate"),
    ("host/RT_exp_a", "host_RT_exp_a"),
    ("host/RT_exp_b", "host_RT_exp_b"),
    ("host/necrosis_rate", "host_necrosis_rate"),
    ("tumour/diffusion", "tumour_diffusion"),
    ("tumour/diffusion_host", "tumour_diffusion_host"),
    ("tumour/proliferation", "tumour_proliferation"),
    ("tumour/vsc_threshold", "tumour_vsc_threshold"),
    ("tumour/RT_death_rate", "tumour_RT_death_rate"),
    ("tumour/RT_exp_a", "tumour_RT_exp_a"),
    ("tumour/RT_exp_b", "tumour_RT_exp_b"),
    ("tumour/necrosis_rate", "tumour_necrosis_rate"),
    ("necrosis/clearance", "necrosis_clearance"),
    ("necrosis/slope", "necrosis_slope"),
    ("necrosis/vsc_threshold", "necrosis_vsc_threshold"),
    ("vascular/proliferation", "vascular_proliferation"),
    ("vascular/necrosis_rate", "vascular_necrosis_rate"),
    ("oedema/diffusion", "oedema_diffusion"),
    ("oedema/proliferation", "oedema_proliferation"),
    ("oedema/vsc_threshold", "oedema_vsc_threshold"),
    ("oedema/oedema_threshold", "oedema_oedema_threshold"),
    ("oedema/RT_coeff", "oedema_RT_coeff"),
    ("oedema/RT_exp", "oedema_RT_exp"),
    ("oedema/reabsorption_rate", "oedema_reabsorption_rate"),
]


def load_params(deck: Deck) -> dict:
    """Deck key -> physics params; every model default is 1.0
    (src/proteas.C:178-213)."""
    p = {"dt": deck("time_step", 1.0e-9)}
    for deck_key, pkey in _PARAM_KEYS:
        p[pkey] = deck(deck_key, 1.0)
    return p


def rtd_at_qp(mesh, aux: np.ndarray, sampling: str = "full"):
    """The dose at the quadrature points, (Q, E), from the nodal AUX (HU,
    RTD) (N, 2): the interpolation of RTD, or with sampling "reference"
    the C++ reference's phi_1(qp) * HU(local node 1).  On a MixedMesh a
    tuple of one (Q_b, E_b) array per block, in block order."""
    out = []
    for etype, conn in element_blocks(mesh):
        phi = tabulate(etype)[0]
        if sampling == "reference":
            out.append(phi[:, 1][:, None] * aux[conn[:, 1], 0][None, :])
        else:
            out.append(np.einsum("qk,ek->qe", phi, aux[conn, 1]))
    return tuple(out) if mesh.elem_type == "MIXED" else out[0]


def run(deck_path: str = "input.dat", device=None) -> str:
    """Run the deck at `deck_path`; returns the results directory.  device
    None is the CUDA card (RuntimeError without one)."""
    dev = cuda_device() if device is None else torch.device(device)
    plog = PerfLog("proteas")
    deck = Deck(deck_path)

    input_gmsh = deck("input_GMSH", "input.msh")
    input_nodal = deck("input_nodal", "input.nd")
    input_aux = deck("input_nodal_aux", "input_aux.nd")
    DIR = provenance.prepare_results_dir(deck("directory", "") or None,
                                         deck_path)
    pv_base = os.path.basename(DIR.rstrip("/"))
    out_pv = os.path.join(DIR, deck("output_Paraview", pv_base))
    out_csv = os.path.join(DIR, deck("output_CSV", pv_base + ".csv"))

    n_steps = deck("time_step_number", 1)
    dt = deck("time_step", 1.0e-9)
    # consumed as the reference consumes them: AMR is a stub there too
    for key, default in (("refinement_step", 1 + n_steps),
                         ("mesh/skip_renumber_nodes_and_elements", True),
                         ("mesh/AMR/max_steps", 0),
                         ("mesh/AMR/max_level", 3),
                         ("mesh/AMR/refine_percentage", 0.5),
                         ("mesh/AMR/coarsen_percentage", 0.5)):
        deck(key, default)
    otp = output_time_points(deck, n_steps)

    with plog.scope("mesh io"):
        mesh = gmsh.read(input_gmsh)
        print(mesh.print_info())

    with plog.scope("initial conditions"):
        u0 = dat.read_rows_tolerant(input_nodal, mesh.n_nodes, 5)
        aux = dat.read_rows_tolerant(input_aux, mesh.n_nodes, 2)  # HU, RTD

    params = load_params(deck)
    sampling = deck("proteas/aux_sampling", "full")

    with plog.scope("system setup"):
        system = make_rdc_system(mesh, 5, proteas_blocks, deck, device=dev)
        state = system.initial_state(u0)
        # the AUX file is static: the dose at qp is built once
        rtd = rtd_at_qp(mesh, aux, sampling)
        as_dev = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                           device=dev)
        if isinstance(system, HaloShardedSystem):
            fields = {"RTD": system.shard_elem_field(rtd)}
        else:
            fields = {"RTD": (tuple(map(as_dev, rtd))
                              if isinstance(rtd, tuple) else as_dev(rtd))}

    paraview = ParaviewWriter(mesh)
    # a resumed run in the same results dir appends instead of truncating
    ckpt_step = deck("checkpoint/step", 0)
    ckpt_resume = deck("checkpoint/resume", "")
    resuming = bool(ckpt_resume) and os.path.exists(out_csv)
    paraview.open_pvd(out_pv, resume=resuming)
    csv = open(out_csv, "a" if resuming else "w")  # never written

    def save(t: int):
        u = system.gather(state["u"])
        with plog.scope("vtu output"):
            out = [(name, u[:, i]) for i, name in enumerate(PROTEAS_VARS)]
            out += [("HU", aux[:, 0]), ("RTD", aux[:, 1])]
            paraview.update_pvd(
                out, t, processor_id=getattr(system, "processor_id", None))

    start_step = 0
    if ckpt_resume:
        st, start_step, _time, _ = load_checkpoint(ckpt_resume, params)
        state = system.scatter_state(st)
        print(f"resumed from {ckpt_resume} at step {start_step}")
    else:
        save(0)

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
            with plog.scope("solve"):
                state, _its, _res = system.run_steps(state, seg,
                                                     fields=fields,
                                                     params=params)
            for k in range(t + 1, t + seg + 1):
                step_banner(k, n_steps, dt * k)
            t += seg
            if ckpt_step and t % ckpt_step == 0:
                with plog.scope("checkpoint"):
                    save_checkpoint(os.path.join(DIR, "checkpoint.npz"),
                                    system.gather_state(state), t, dt * t,
                                    params)
            if t in otp:
                save(t)

    csv.close()
    paraview.close_pvd()
    deck.warn_unused()
    plog.report()
    return DIR
