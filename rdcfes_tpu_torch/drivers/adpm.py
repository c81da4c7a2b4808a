"""ADPM driver: Alzheimer's disease progression (the flow of
rdcfes_tpu.drivers.adpm; C++ reference src/adpm.C:15-87).

Flow: deck -> results dir -> Gmsh read + processed copy -> nodal ICs
(PrP, A_b, Tau) + elemental fibre tracts -> time loop with time-weighted
PrP decay -> per-parcellation CSV + VTU/PVD, and an optional checkpoint
every `checkpoint/step`.

The tracts are an element field on the system's device; the advancing
`time` (it gates the time^gamma PrP decay, src/adpm.C:268-296) is the
`scalar_traj` of the one `run_steps` call that takes the steps between
two events.  `parallel/n_devices` > 1 and meshes other than single-type
TET4 or HEX8 raise NotImplementedError (ROADMAP queue 1 items 14, 13).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fem.assembly import interpolate_at_qp
from ..fem.geometry import geometry_factors
from ..io import dat, provenance
from ..io.csv_metrics import adpm_header, adpm_row
from ..io.getpot import Deck
from ..io.vtu import ParaviewWriter, elemental_to_nodal
from ..mesh import gmsh
from ..models.adpm import ADPM_VARS, adpm_blocks
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import cuda_device
from .common import (PerfLog, make_rdc_system, maybe_profile,
                     output_time_points, step_banner)


def load_params(deck: Deck) -> dict:
    """Deck key -> physics param mapping (src/adpm.C:162-225)."""
    p = {"dt": deck("time_step", 1.0e-9)}
    p["decay_PrP"] = deck("decay/PrP", 0.0)
    p["decay_PrP_pulse0"] = deck("decay/PrP/pulse/0", -1.0e-20)
    p["decay_PrP_pulse1"] = deck("decay/PrP/pulse/1", 1.0e20)
    p["decay_PrP_time_exponent"] = deck("decay/PrP/time_exponent", 0.0)
    for s in ("A_b", "Tau"):
        p[f"transform_{s}"] = deck(f"transform/{s}", 0.0)
        p[f"transform_{s}_t0"] = deck(f"transform/{s}/trapezoid/0", -1.1e-20)
        p[f"transform_{s}_t1"] = deck(f"transform/{s}/trapezoid/1", -1.0e-20)
        p[f"transform_{s}_t2"] = deck(f"transform/{s}/trapezoid/2", 1.0e20)
        p[f"transform_{s}_t3"] = deck(f"transform/{s}/trapezoid/3", 1.1e20)
        p[f"diffuse_{s}"] = deck(f"diffuse/{s}", 0.0)
        p[f"diffuse_{s}_pulse0"] = deck(f"diffuse/{s}/pulse/0", -1.0e-20)
        p[f"diffuse_{s}_pulse1"] = deck(f"diffuse/{s}/pulse/1", 1.0e20)
        p[f"taxis1_{s}"] = deck(f"taxis_1/{s}", 0.0)
        p[f"taxis1_{s}_pulse0"] = deck(f"taxis_1/{s}/pulse/0", -1.0e-20)
        p[f"taxis1_{s}_pulse1"] = deck(f"taxis_1/{s}/pulse/1", 1.0e20)
        p[f"taxis2_{s}"] = deck(f"taxis_2/{s}", 0.0)
        p[f"taxis2_{s}_pulse0"] = deck(f"taxis_2/{s}/pulse/0", -1.0e-20)
        p[f"taxis2_{s}_pulse1"] = deck(f"taxis_2/{s}/pulse/1", 1.0e20)
        p[f"produce_{s}"] = deck(f"produce/{s}", 0.0)
        p[f"produce_{s}_s0"] = deck(f"produce/{s}/sigmoid/0", 1.0e20)
        p[f"produce_{s}_s1"] = deck(f"produce/{s}/sigmoid/1", 1.1e20)
        p[f"decay_{s}"] = deck(f"decay/{s}", 0.0)
        p[f"decay_{s}_pulse0"] = deck(f"decay/{s}/pulse/0", -1.0e-20)
        p[f"decay_{s}_pulse1"] = deck(f"decay/{s}/pulse/1", 1.0e20)
        # tolerance angle -> cosine gate (src/adpm.C:412-414)
        p[f"omega_{s}"] = float(np.cos(np.deg2rad(deck(f"taxis/{s}/angle", 89.9))))
    return p


def run(deck_path: str = "input.dat", device=None) -> str:
    """Run the deck at `deck_path`; returns the results directory.  device
    None is the CUDA card (RuntimeError without one)."""
    dev = cuda_device() if device is None else torch.device(device)
    plog = PerfLog("adpm")
    deck = Deck(deck_path)

    input_gmsh = deck("input_GMSH", "input.msh")
    input_nodal = deck("input_nodal", "input.nodal")
    input_elem = deck("input_elemental", "input.elemental")
    DIR = provenance.prepare_results_dir(
        deck("directory", "") or None, deck_path, [input_nodal, input_elem]
    )
    out_gmsh = os.path.join(DIR, deck("output_GMSH", "output.msh"))
    out_pv = os.path.join(DIR, deck("output_PARAVIEW", "output4paraview"))
    out_csv = os.path.join(DIR, deck("output_CSV", "output.csv"))

    n_steps = deck("time_step_number", 1)
    dt = deck("time_step", 1.0e-9)
    deck("mesh/skip_renumber_nodes_and_elements", True)
    otp = output_time_points(deck, n_steps)

    ranges = {
        "range_A_b_min": deck("range/A_b/min", 1.0e-12),
        "range_A_b_max": deck("range/A_b/max", 1.0e12),
        "range_Tau_min": deck("range/Tau/min", 1.0e-12),
        "range_Tau_max": deck("range/Tau/max", 1.0e12),
    }

    with plog.scope("mesh io"):
        mesh = gmsh.read(input_gmsh)
        print(mesh.print_info())
        gmsh.write(mesh, out_gmsh)

    with plog.scope("initial conditions"):
        u0 = dat.read_stream(input_nodal, mesh.n_nodes, 3)
        tracts = dat.read_stream(input_elem, mesh.n_elems, 3)

    params = load_params(deck)

    with plog.scope("system setup"):
        system = make_rdc_system(mesh, 3, adpm_blocks, deck, device=dev)
        state = system.initial_state(u0)

    paraview = ParaviewWriter(mesh)
    # a resumed run in the same results dir appends instead of truncating
    resuming = bool(deck("checkpoint/resume", "")) and os.path.exists(out_csv)
    paraview.open_pvd(out_pv, resume=resuming)
    csv = open(out_csv, "a" if resuming else "w")
    parcellation = sorted(int(s) for s in np.unique(mesh.subdomain_id))
    if not resuming:
        adpm_header(csv, parcellation)

    tract_fields = [
        ("TractX", elemental_to_nodal(mesh, tracts[:, 0])),
        ("TractY", elemental_to_nodal(mesh, tracts[:, 1])),
        ("TractZ", elemental_to_nodal(mesh, tracts[:, 2])),
    ]
    tracts_field = torch.as_tensor(tracts, dtype=torch.float64, device=dev)

    # the CSV's own quadrature geometry, independent of the system's
    conn_T = torch.as_tensor(np.ascontiguousarray(mesh.connectivity.T),
                             device=dev)
    phi, JxW, dphi = geometry_factors(
        torch.as_tensor(mesh.coords, dtype=torch.float64, device=dev),
        conn_T.T, mesh.elem_type)

    def elem_averages(u: torch.Tensor) -> np.ndarray:
        """JxW-integrated (A_b, Tau) per element (E, 2) from u (N, V):
        the quadrature loop of save_solution (src/adpm.C:765-781)."""
        u_qp, _ = interpolate_at_qp(u.T, conn_T, phi, dphi)
        return torch.einsum("vqe,qe->ve", u_qp[1:3], JxW).T.cpu().numpy()

    def save(t: int, time_value: float):
        u = state["u"].cpu().numpy()
        with plog.scope("csv output"):
            adpm_row(csv, mesh, u, time_value, ranges,
                     elem_averages(state["u"]))
        with plog.scope("vtu output"):
            fields = [(name, u[:, i]) for i, name in enumerate(ADPM_VARS)]
            fields += tract_fields
            paraview.update_pvd(fields, t)

    ckpt_step = deck("checkpoint/step", 0)
    ckpt_resume = deck("checkpoint/resume", "")
    start_step = 0
    time_value = 0.0
    if ckpt_resume:
        st, start_step, time_value, _ = load_checkpoint(ckpt_resume, params)
        state = system.scatter_state(st)
        print(f"resumed from {ckpt_resume} at step {start_step}")
    else:
        save(0, 0.0)

    def next_event(t: int) -> int:
        nxt = n_steps
        if ckpt_step:
            nxt = min(nxt, ((t // ckpt_step) + 1) * ckpt_step)
        future = [s for s in otp if s > t]
        if future:
            nxt = min(nxt, min(future))
        return nxt

    fields = {"tracts": tracts_field}
    with maybe_profile():
        t = start_step
        while t < n_steps:
            seg = next_event(t) - t
            if seg > 1:
                times = time_value + dt * np.arange(1, seg + 1)
                with plog.scope("solve"):
                    state, _its, _res = system.run_steps(
                        state, seg, fields=fields, params=params,
                        scalar_traj={"time": times})
                for j in range(seg):
                    time_value += dt
                    step_banner(t + 1 + j, n_steps, time_value)
                t += seg
            else:
                t += 1
                time_value += dt
                step_banner(t, n_steps, time_value)
                with plog.scope("solve"):
                    state, _its, _res = system.step(
                        state, fields=fields,
                        scalars={"time": time_value}, params=params)
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
