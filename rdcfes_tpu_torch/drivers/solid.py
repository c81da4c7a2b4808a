"""Solid driver: quasi-static hyperelastic load stepping (the flow of
rdcfes_tpu.drivers.solid; C++ reference src/solid.C:14-112).

Flow: deck -> (wiped) results dir -> Gmsh read + processed copy ->
optional fibre file -> pseudo-time ramp: Newton equilibrium solve, stress
post-processing (pressure, Von Mises, fibre push-forward), remeshing at
the `remeshing_step` schedule while `mesh/AMR/max_steps` allows
(drivers/common.Remesher on the pressure and Von Mises fields: MIXED
with hanging nodes, TET4 and TET10 by bisection, HEX8 uniformly; the
current positions P1-prolonged, the elemental fields transferred, the
system rebuilt), VTU output with the current positions as Points; an
optional checkpoint every `checkpoint/step`, which after remeshing also
holds the refined mesh (`checkpoint_mesh.msh` beside it, and its
coordinates at full precision as `mesh_coords`, which the reference's
resume ignores: the Gmsh file has 6 significant digits), `amr_done`,
the fibres and a MixedMesh's hanging-node rows, and resumes on that
mesh.  A resumed MixedMesh also gets its hanging set back, so that a
later pass refines on it (the reference rebuilds it from the mesh).

Deck notes (the reference's sharp edges, kept):
  * number_of_loading_steps = int(1.0 / loading_step) (src/solid.C:153-154)
  * material keys are read under `material/<id>/Hyperelastic/...`; the
    shipped decks write `Neohookean`, so the reference silently uses the
    defaults E=1e3, nu=0.3 — the unused-key warning shows it
  * BC displacement components parse NAN = unconstrained axis

Precision defaults follow the device: on the CUDA card a "mixed" Krylov
and an "f32" tangent, on the CPU "f64" for both (the reference chooses
the same split between its accelerator and the CPU); the deck keys
`solver/linear/precision` and `solver/nonlinear/tangent_precision`
override.  `solver/linear/fast_gather` is read and ignored: the TPU's
Beneš-routed SpMV has no counterpart here.

`parallel/n_devices` = D > 1 runs each load step on D shards through the
halo Newton (SolidSystem(device_mesh=D), parallel/solid_halo.py), in f64
whatever the tangent precision (SolidSystem prints the reference's
notice).  A system with hanging nodes runs on one device (the resumed
remeshed MixedMesh), and a MixedMesh at D > 1 is not remeshed: the
driver prints the reference's notice and goes on on the fixed mesh.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from ..io import dat, provenance
from ..io.getpot import Deck, export_integers
from ..io.vtu import ParaviewWriter, elemental_to_nodal
from ..mesh import gmsh
from ..solvers.newton import NewtonOptions
from ..systems import SolidSystem
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import cuda_device
from .common import (PerfLog, Remesher, make_solid_device_mesh,
                     step_banner)


def load_newton_options(deck: Deck, device) -> NewtonOptions:
    """solver/* knobs (src/solid.C:216-238, src/solid_system.C:86-100);
    the linear precision defaults to "mixed" on the CUDA card, "f64" on
    the CPU."""
    deck("solver/quiet", False)
    deck("solver/assembly_use_symmetry", False)
    deck("solver/linear/fast_gather", "")
    on_card = torch.device(device).type == "cuda"
    return NewtonOptions(
        max_nonlinear_iterations=deck("solver/nonlinear/max_nonlinear_iterations", 100),
        relative_step_tolerance=deck("solver/nonlinear/relative_step_tolerance", 1e-3),
        relative_residual_tolerance=deck("solver/nonlinear/relative_residual_tolerance", 1e-8),
        absolute_residual_tolerance=deck("solver/nonlinear/absolute_residual_tolerance", 1e-8),
        require_residual_reduction=deck("solver/nonlinear/require_reduction", False),
        max_linear_iterations=deck("solver/linear/max_linear_iterations", 50000),
        initial_linear_tolerance=deck("solver/linear/initial_linear_tolerance", 1e-3),
        linear_precision=deck("solver/linear/precision", "")
        or ("mixed" if on_card else "f64"),
        # modified Newton: keep the assembled tangent while the residual
        # contracts (solvers/newton.py)
        reuse_tangent=deck("solver/nonlinear/reuse_tangent", False),
    )


def load_tangent_precision(deck: Deck, device) -> str:
    """solver/nonlinear/tangent_precision: "f32" evaluates, contracts and
    gathers the tangent in single precision (the residual the Newton
    rules see stays f64).  Default "f32" on the CUDA card, "f64" on the
    CPU."""
    on_card = torch.device(device).type == "cuda"
    return (deck("solver/nonlinear/tangent_precision", "")
            or ("f32" if on_card else "f64"))


def load_bcs(deck: Deck) -> dict:
    """BCs table (src/solid.C:240-259): id -> (dx, dy, dz), NaN = free."""
    bcs = {}
    for bc in export_integers(deck("BCs", " 0 ")):
        bcs[bc] = tuple(
            deck(f"BC/{bc}/displacement/{d}", 0.0) for d in range(3))
    return bcs


def load_materials(deck: Deck) -> dict:
    """Materials table (src/solid.C:261-280)."""
    mats = {}
    for m in export_integers(deck("materials", " 0 ")):
        key = f"material/{m}/Hyperelastic"
        mats[m] = {
            "young": deck(f"{key}/Young", 1.0e3),
            "poisson": deck(f"{key}/Poisson", 0.3),
            "fibre_stiffness": deck(f"{key}/FibreStiffness", 0.0),
            "stretch_rate_0": deck(f"{key}/VolumetricStretchRatio/rate_0", 0.0),
            "stretch_rate_1": deck(f"{key}/VolumetricStretchRatio/rate_1", 0.0),
            "stretch_rate_2": deck(f"{key}/VolumetricStretchRatio/rate_2", 0.0),
        }
    return mats


def load_fibres(deck: Deck, mesh) -> np.ndarray:
    """Per-element fibre unit vectors; errors on degenerate rows
    (src/solid.C:285-328)."""
    name = deck("input_fibres", ".")
    if name == ".":
        return np.zeros((mesh.n_elems, 3))
    raw = dat.read_stream(name, mesh.n_elems, 3)
    norms = np.linalg.norm(raw, axis=1)
    if (norms <= 1.0e-6).any():
        raise ValueError(f"{name}: degenerate fibre vector (|v| <= 1e-6)")
    return raw / norms[:, None]


def make_solid(deck: Deck, mesh, fibres: np.ndarray, device,
               constraints: Optional[np.ndarray] = None) -> SolidSystem:
    """The SolidSystem of a deck on `mesh` (the drivers build it again
    after every remeshing): on `parallel/n_devices` shards
    (make_solid_device_mesh) unless it has hanging-node constraints,
    which run on one device, as the reference's resume does."""
    has_cons = constraints is not None and len(constraints)
    return SolidSystem(
        mesh, materials=load_materials(deck), bcs=load_bcs(deck),
        penalty=deck("BCs/displacement_penalty", 1.0e5), fibres=fibres,
        newton=load_newton_options(deck, device),
        tangent_precision=load_tangent_precision(deck, device),
        constraints=constraints, device=device,
        device_mesh=None if has_cons else make_solid_device_mesh(deck))


def load_remesher(deck: Deck, tet10_bisection: bool) -> Remesher:
    """mesh/AMR/* (src/solid.C:156-200)."""
    deck("mesh/skip_renumber_nodes_and_elements", True)
    return Remesher(deck("mesh/AMR/refine_percentage", 0.5),
                    deck("mesh/AMR/coarsen_percentage", 0.5),
                    deck("mesh/AMR/max_level", 3), tet10_bisection)


def schedule(deck: Deck, n_steps: int, step_key: str, default_past_end: bool):
    """output/remeshing schedules (src/solid.C:156-200): step==0 means only
    the final step (output) or never (remeshing: 1+n_steps)."""
    step = deck(step_key, 0)
    if step == 0:
        return {n_steps + 1} if default_past_end else {n_steps}
    return set(range(step, n_steps + 1, step))


def run(deck_path: str = "input.dat", device=None) -> str:
    """Run the deck at `deck_path`; returns the results directory.  device
    None is the CUDA card (RuntimeError without one)."""
    dev = cuda_device() if device is None else torch.device(device)
    plog = PerfLog("solid")
    deck = Deck(deck_path)
    n_shards = make_solid_device_mesh(deck)

    input_gmsh = deck("input_GMSH", "input.msh")
    DIR = provenance.prepare_results_dir(
        deck("directory", "") or None, deck_path, wipe=True
    )
    out_gmsh = os.path.join(DIR, deck("output_GMSH", "output.msh"))
    out_pv = os.path.join(DIR, deck("output_PARAVIEW", "output4paraview"))

    loading_step = deck("loading_step", 1.0)
    n_load_steps = int(1.0 / loading_step)
    otp = (set(export_integers(deck("output_time_points", "")))
           if deck.have("output_time_points")
           else schedule(deck, n_load_steps, "output_step", False))
    if deck.have("output_time_points"):
        deck("output_step", 0)
    rtp = schedule(deck, n_load_steps, "remeshing_step", True)
    amr_max_steps = deck("mesh/AMR/max_steps", 0)
    remesher = load_remesher(deck, tet10_bisection=True)

    with plog.scope("mesh io"):
        mesh = gmsh.read(input_gmsh)
        print(mesh.print_info())
        gmsh.write(mesh, out_gmsh)

    ckpt_step = deck("checkpoint/step", 0)
    ckpt_resume = deck("checkpoint/resume", "")

    fibres = load_fibres(deck, mesh)
    penalty = deck("BCs/displacement_penalty", 1.0e5)
    ck_params = {"loading_step": loading_step, "penalty": penalty}
    amr_done = 0
    if ckpt_resume:
        st, start_step, pseudo_time, extra = load_checkpoint(ckpt_resume,
                                                             ck_params)
        mesh, fibres, amr_done = remesher.resume(ckpt_resume, extra, mesh,
                                                 fibres)
    with plog.scope("system setup"):
        system = make_solid(deck, mesh, fibres, dev, remesher.constraints)
    x = system.initial_positions()

    paraview = ParaviewWriter(mesh)
    paraview.open_pvd(out_pv, resume=bool(ckpt_resume))

    p_elem = np.zeros(mesh.n_elems)
    vm_elem = np.zeros(mesh.n_elems)
    fibre_cur = fibres.copy()

    def save(t: int):
        xs = x.cpu().numpy()
        u = system.displacement(x).cpu().numpy()
        with plog.scope("vtu output"):
            fields = [
                ("x", xs[:, 0]), ("y", xs[:, 1]), ("z", xs[:, 2]),
                ("undeformed_x", mesh.coords[:, 0]),
                ("undeformed_y", mesh.coords[:, 1]),
                ("undeformed_z", mesh.coords[:, 2]),
                ("u_x", u[:, 0]), ("u_y", u[:, 1]), ("u_z", u[:, 2]),
                ("fibre_reference_x", elemental_to_nodal(mesh, fibres[:, 0])),
                ("fibre_reference_y", elemental_to_nodal(mesh, fibres[:, 1])),
                ("fibre_reference_z", elemental_to_nodal(mesh, fibres[:, 2])),
                ("fibre_current_x", elemental_to_nodal(mesh, fibre_cur[:, 0])),
                ("fibre_current_y", elemental_to_nodal(mesh, fibre_cur[:, 1])),
                ("fibre_current_z", elemental_to_nodal(mesh, fibre_cur[:, 2])),
                ("p", elemental_to_nodal(mesh, p_elem)),
                ("VM", elemental_to_nodal(mesh, vm_elem)),
            ]
            # current positions travel as the Points array too
            paraview.update_pvd(fields, t, coords=xs)

    if ckpt_resume:
        if amr_done:
            print(f"resumed on remeshed grid ({mesh.n_elems} elements)")
        x = torch.as_tensor(st["x"], dtype=torch.float64, device=dev)
        p_elem = extra.get("p_elem", p_elem)
        vm_elem = extra.get("vm_elem", vm_elem)
        fibre_cur = extra.get("fibre_cur", fibre_cur)
        print(f"resumed from {ckpt_resume} at load step {start_step}")
    else:
        start_step, pseudo_time = 0, 0.0
        save(0)

    for l in range(start_step + 1, n_load_steps + 1):
        pseudo_time += loading_step
        step_banner(l, n_load_steps, pseudo_time, label="pseudo-time")
        with plog.scope("newton solve"):
            res = system.run_solver(x, pseudo_time)
            x = res.x
        print(f"   Newton: {int(res.iters)} iterations, "
              f"|R| {float(res.residual_norm):.3e}")
        with plog.scope("post process"):
            p_j, vm_j, fc_j = system.post_process(x, pseudo_time)
            p_elem = p_j.cpu().numpy()
            vm_elem = vm_j.cpu().numpy()
            fibre_cur = fc_j.cpu().numpy()
        if (l in rtp and amr_done < amr_max_steps
                and mesh.elem_type == "MIXED" and n_shards is not None):
            # the halo Newton takes no hanging nodes: the reference's
            # notice, and the fixed mesh
            print(f"remeshing step {l}: mixed-element solid remeshing is "
                  "single-chip only; continuing on the fixed mesh",
                  file=sys.stderr)
        elif l in rtp and amr_done < amr_max_steps:
            amr_done += 1
            with plog.scope("remeshing"):
                ind = np.stack([elemental_to_nodal(mesh, p_elem),
                                elemental_to_nodal(mesh, vm_elem)], axis=1)
                r = remesher.remesh(l, mesh, ind)
                if r is not None:
                    mesh = r.mesh
                    # the current positions P1-prolonged: a new node
                    # lands at the (deformed) midpoint of its parents, so
                    # every hanging constraint holds exactly
                    x_new = r.prolong(x.cpu().numpy())
                    fibres = r.elemental(fibres)
                    p_elem = r.elemental(p_elem)
                    vm_elem = r.elemental(vm_elem)
                    fibre_cur = r.elemental(fibre_cur)
                    system = make_solid(deck, mesh, fibres, dev,
                                        remesher.constraints)
                    x = torch.as_tensor(x_new, dtype=torch.float64,
                                        device=dev)
                    paraview.mesh = mesh
        elif l in rtp and amr_max_steps == 0:
            print("NOTE: remeshing step reached but mesh/AMR/max_steps = 0",
                  file=sys.stderr)
        if ckpt_step and l % ckpt_step == 0:
            with plog.scope("checkpoint"):
                extras = {"fibres": fibres, "p_elem": p_elem,
                          "vm_elem": vm_elem, "fibre_cur": fibre_cur,
                          **remesher.checkpoint_extras(DIR, mesh, amr_done)}
                save_checkpoint(
                    os.path.join(DIR, "checkpoint.npz"), {"x": x}, l,
                    pseudo_time, ck_params, **extras)
        if l in otp:
            save(l)

    paraview.close_pvd()
    deck.warn_unused()
    plog.report()
    return DIR
