"""Coupled HCC driver: two-way RDC <-> solid mechanics (the flow of
rdcfes_tpu.drivers.coupled_hcc; C++ reference src/coupled_hcc.C:17-142).

Interleaved time loop: the 3-species HCC transport solves EVERY step on
the current deformed geometry; the solid equilibrium advances only at the
loading points (every number_of_time_steps / number_of_loading_steps
steps), its growth driven by the per-material volumetric stretch rates at
the accumulated pseudo-time.  Coupling, as in the reference: solid -> RDC
through the moved geometry; RDC -> solid only through the shared
pseudo-time schedule (the mechano-taxis term is inert, models/hcc.py).

The steps between two events (a loading point, an output, a checkpoint)
go through one `run_steps(coords=x)` call, which builds the geometry from
the positions x once; a one-step segment too, since on the port's qp
path it is the same operator as the reference's assembled one-step
`step(coords=x)`.  x stays on the device.  The solid's precision follows
the device as in drivers/solid.py (an f32 tangent and a mixed Krylov on
the card, f64 on the CPU; the deck keys override).

Meshes: TET4, HEX8 and TET10 (TransientRDCSystem with moving_mesh=True)
and MIXED (MixedTransientRDCSystem with moving_mesh=True, in mixed
precision as the reference's), with the solid on the same mesh.

Remeshing, at the `remeshing_step` schedule while `mesh/AMR/max_steps`
allows (drivers/common.Remesher on the nodal pressure and the tumour c):
MIXED with hanging nodes (both systems then get `constraints=`), TET4 by
bisection, HEX8 uniformly; TET10 raises ValueError there, as the
reference's `refine_flagged` does.  The RDC state and the positions are
P1-prolonged, the elemental fields transferred, and both systems rebuilt
on the refined mesh.  A checkpoint written after remeshing holds the
refined mesh (`checkpoint_mesh.msh` beside it, and its coordinates at
full precision as `mesh_coords`, which the reference's resume ignores:
the Gmsh file has 6 significant digits), `amr_done`, the fibres and a
MixedMesh's hanging-node rows, and resumes on that mesh.

`parallel/n_devices` = D > 1 runs both halves on D shards: the transport
through the moving mesh of parallel.halo.HaloShardedSystem (each shard's
geometry from its ghost-filled positions, built once a segment) and the
solid through the halo Newton (parallel/solid_halo.py, f64).  Systems
with hanging nodes (a resumed remeshed MixedMesh) run the solid on one
device, and a MixedMesh at D > 1 is not remeshed: the driver prints the
reference's notice and goes on on the fixed mesh.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import dat, provenance
from ..io.getpot import Deck
from ..io.vtu import ParaviewWriter, elemental_to_nodal
from ..mesh import gmsh
from ..models.hcc import HCC_VARS, hcc_blocks
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import cuda_device
from .common import (PerfLog, make_rdc_system, make_solid_device_mesh,
                     maybe_profile, step_banner)
from .solid import load_fibres, load_remesher, make_solid


def load_params(deck: Deck) -> dict:
    """Deck key -> HCC physics params (src/coupled_hcc.C:350-370), with the
    necrosis/* -> /Kappa_k scaling (src/coupled_hcc.C:459-461)."""
    Kk = deck("cells/max_capacity", 1.0)
    return {
        "dt": deck("time_step", 1.0),
        "cells_min_capacity": deck("cells/min_capacity", 0.0),
        "cells_max_capacity": Kk,
        "cells_max_capacity_exponent": deck("cells/max_capacity/exponent",
                                            1.0),
        "produce_l": deck("produce/l", 0.0),
        "diffuse_c": deck("diffuse/c", 0.0),
        "mechano_c": deck("mechano/c", 0.0),
        "produce_c": deck("produce/c", 0.0),
        "necrosis_l": deck("necrosis/l", 0.0) / Kk,
        "necrosis_c": deck("necrosis/c", 0.0) / Kk,
        "necrosis_pressure": deck("necrosis/pressure", 0.0) / Kk,
    }


def run(deck_path: str = "input.dat", device=None) -> str:
    """Run the deck at `deck_path`; returns the results directory.  device
    None is the CUDA card (RuntimeError without one)."""
    dev = cuda_device() if device is None else torch.device(device)
    plog = PerfLog("coupled_hcc")
    deck = Deck(deck_path)
    n_shards = make_solid_device_mesh(deck)

    input_gmsh = deck("input_GMSH", "input.msh")
    input_nodal = deck("input_nodal", "input.nodal")
    dt = deck("time_step", 1.0)
    n_steps = deck("number_of_time_steps", 1)
    n_loading = deck("number_of_loading_steps", 1)
    if n_steps % n_loading:
        raise ValueError(
            "number_of_time_steps must be a multiple of "
            "number_of_loading_steps (src/coupled_hcc.C:202-206)")
    loading_step = (dt * n_steps) / n_loading
    stride = n_steps // n_loading
    ltp = set(range(stride, n_steps + 1, stride))
    out_step = deck("output_step", 0)
    otp = (set(range(out_step, n_steps + 1, out_step)) if out_step
           else {n_steps})
    rem_step = deck("remeshing_step", 0)
    # without AMR steps a remeshing point only ends a segment, as in the
    # reference
    rtp = set(range(rem_step, n_steps + 1, rem_step)) if rem_step else set()
    amr_max_steps = deck("mesh/AMR/max_steps", 0)
    remesher = load_remesher(deck, tet10_bisection=False)
    DIR = provenance.prepare_results_dir(
        deck("directory", "") or None, deck_path, [input_nodal], wipe=True)
    out_gmsh = os.path.join(DIR, deck("output_GMSH", "output.msh"))
    out_pv = os.path.join(DIR, deck("output_PARAVIEW", "output4paraview"))

    with plog.scope("mesh io"):
        mesh = gmsh.read(input_gmsh)
        print(mesh.print_info())
        gmsh.write(mesh, out_gmsh)

    with plog.scope("initial conditions"):
        u0 = dat.read_stream(input_nodal, mesh.n_nodes, 3)

    params = load_params(deck)
    fibres = load_fibres(deck, mesh)
    penalty = deck("BCs/displacement_penalty", 1.0e5)
    ckpt_step = deck("checkpoint/step", 0)
    ckpt_resume = deck("checkpoint/resume", "")
    ck_params = dict(params, loading_step=loading_step, penalty=penalty)
    amr_done = 0
    if ckpt_resume:
        st, start_step, time_value, extra = load_checkpoint(ckpt_resume,
                                                            ck_params)
        mesh, fibres, amr_done = remesher.resume(ckpt_resume, extra, mesh,
                                                 fibres)

    def build(mesh, fibres):
        """Both systems on `mesh`, with the remesher's hanging nodes: the
        RDC transport on the moving mesh and the solid, on the deck's
        shards (the solid on one device with hanging nodes)."""
        cons = remesher.constraints
        return (make_rdc_system(mesh, 3, hcc_blocks, deck, device=dev,
                                moving_mesh=True, constraints=cons),
                make_solid(deck, mesh, fibres, dev, cons))

    with plog.scope("system setup"):
        rds, solid = build(mesh, fibres)
    state = rds.initial_state(u0) if not ckpt_resume else None
    x = solid.initial_positions()

    paraview = ParaviewWriter(mesh)
    paraview.open_pvd(out_pv, resume=bool(ckpt_resume))

    p_elem = np.zeros(mesh.n_elems)
    vm_elem = np.zeros(mesh.n_elems)
    fibre_cur = fibres.copy()

    def save(t: int):
        u = rds.gather(state["u"])
        xs = x.cpu().numpy()
        disp = solid.displacement(x).cpu().numpy()
        with plog.scope("vtu output"):
            fields = [(name, u[:, i]) for i, name in enumerate(HCC_VARS)]
            fields += [
                ("x", xs[:, 0]), ("y", xs[:, 1]), ("z", xs[:, 2]),
                ("undeformed_x", mesh.coords[:, 0]),
                ("undeformed_y", mesh.coords[:, 1]),
                ("undeformed_z", mesh.coords[:, 2]),
                ("u_x", disp[:, 0]), ("u_y", disp[:, 1]),
                ("u_z", disp[:, 2]),
                ("fibre_reference_x", elemental_to_nodal(mesh, fibres[:, 0])),
                ("fibre_reference_y", elemental_to_nodal(mesh, fibres[:, 1])),
                ("fibre_reference_z", elemental_to_nodal(mesh, fibres[:, 2])),
                ("fibre_current_x", elemental_to_nodal(mesh, fibre_cur[:, 0])),
                ("fibre_current_y", elemental_to_nodal(mesh, fibre_cur[:, 1])),
                ("fibre_current_z", elemental_to_nodal(mesh, fibre_cur[:, 2])),
                ("p", elemental_to_nodal(mesh, p_elem)),
                ("VM", elemental_to_nodal(mesh, vm_elem)),
            ]
            # the deformed positions travel as the Points array too
            paraview.update_pvd(fields, t, coords=xs)

    if ckpt_resume:
        if amr_done:
            print(f"resumed on remeshed grid ({mesh.n_elems} elements)")
        state = rds.scatter_state(st)
        x = torch.as_tensor(extra["x"], dtype=torch.float64, device=dev)
        pseudo_time = float(extra["pseudo_time"])
        p_elem = extra.get("p_elem", p_elem)
        vm_elem = extra.get("vm_elem", vm_elem)
        fibre_cur = extra.get("fibre_cur", fibre_cur)
        print(f"resumed from {ckpt_resume} at step {start_step}")
    else:
        start_step, time_value, pseudo_time = 0, 0.0, 0.0
        save(0)

    def next_event(tc: int) -> int:
        nxt = n_steps
        for ev in (ltp, otp, rtp):
            future = [s for s in ev if s > tc]
            if future:
                nxt = min(nxt, min(future))
        if ckpt_step:
            nxt = min(nxt, ((tc // ckpt_step) + 1) * ckpt_step)
        return nxt

    with maybe_profile():
        t = start_step
        while t < n_steps:
            # a one-step segment too: run_steps(coords=) is the same
            # operator as the reference's assembled one-step path
            seg = next_event(t) - t
            with plog.scope("rds solve"):
                state, _its, _res = rds.run_steps(state, seg, params=params,
                                                  coords=x)
            for j in range(seg):
                time_value += dt
                step_banner(t + 1 + j, n_steps, time_value, label="time")
            t += seg
            if t in ltp:
                # the solid's equilibrium only at the loading points
                pseudo_time += loading_step
                with plog.scope("solid solve"):
                    nres = solid.run_solver(x, pseudo_time)
                    x = nres.x
                print(f"   Newton: {int(nres.iters)} iterations, "
                      f"|R| {float(nres.residual_norm):.3e}")
                with plog.scope("post process"):
                    p_j, vm_j, fc_j = solid.post_process(x, pseudo_time)
                    p_elem = p_j.cpu().numpy()
                    vm_elem = vm_j.cpu().numpy()
                    fibre_cur = fc_j.cpu().numpy()
            if (t in rtp and amr_done < amr_max_steps
                    and mesh.elem_type == "MIXED" and n_shards is not None):
                # the reference's notice: no hanging nodes on D shards
                print(f"remeshing step {t}: mixed-element remeshing is "
                      "single-chip only; continuing on the fixed mesh")
            elif t in rtp and amr_done < amr_max_steps:
                amr_done += 1
                with plog.scope("remeshing"):
                    gstate = rds.gather_state(state)
                    ind = np.stack([elemental_to_nodal(mesh, p_elem),
                                    gstate["u"][:, 1]], axis=1)
                    r = remesher.remesh(t, mesh, ind)
                    if r is not None:
                        mesh = r.mesh
                        fibres = r.elemental(fibres)
                        p_elem = r.elemental(p_elem)
                        vm_elem = r.elemental(vm_elem)
                        fibre_cur = r.elemental(fibre_cur)
                        x_new = r.prolong(x.cpu().numpy())
                        rds, solid = build(mesh, fibres)
                        state = rds.scatter_state(
                            {k: r.prolong(v) for k, v in gstate.items()})
                        x = torch.as_tensor(x_new, dtype=torch.float64,
                                            device=dev)
                        paraview.mesh = mesh
            if ckpt_step and t % ckpt_step == 0:
                with plog.scope("checkpoint"):
                    extras = {"x": x, "pseudo_time": np.asarray(pseudo_time),
                              "fibres": fibres, "p_elem": p_elem,
                              "vm_elem": vm_elem, "fibre_cur": fibre_cur,
                              **remesher.checkpoint_extras(DIR, mesh,
                                                           amr_done)}
                    save_checkpoint(
                        os.path.join(DIR, "checkpoint.npz"),
                        rds.gather_state(state), t, time_value, ck_params,
                        **extras)
            if t in otp:
                save(t)

    paraview.close_pvd()
    deck.warn_unused()
    plog.report()
    return DIR
