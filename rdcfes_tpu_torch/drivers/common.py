"""Shared driver plumbing: output schedules, step banners, the phase log,
the optional profiler trace, the transient system a driver steps, and
the remeshing of the solid and coupled HCC drivers."""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional, Set

import numpy as np
import torch

from ..fem.amr import flag_by_mean_stddev, kelly_error_indicator
from ..io.getpot import export_integers
from ..mesh import (AdaptiveMesh, MixedConstrained, Tet10Adaptive,
                    adapt_flagged, gmsh, kelly_mixed, refine_flagged)
from ..parallel import HaloShardedSystem
from ..systems import MixedTransientRDCSystem, TransientRDCSystem


@contextmanager
def maybe_profile():
    """A torch.profiler trace of the enclosed steps when
    RDCFES_PROFILE=<dir> is set (the per-kernel view beside PerfLog's
    phase timers); view it with TensorBoard or chrome://tracing."""
    trace_dir = os.environ.get("RDCFES_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
    print(f"profiler trace written to {trace_dir}", file=sys.stderr)


def output_time_points(deck, n_steps: int, key: str = "output_time_points",
                       step_key: str = "output_step") -> Set[int]:
    """The reference's output schedule (src/pihna.C:143-166): the integer
    list `key` when `step_key` is 0 (default: the final step only), else
    every multiple of `step_key`."""
    step = deck(step_key, 0)
    if step == 0:
        return set(export_integers(deck(key, str(n_steps))))
    return set(range(step, n_steps + 1, step))


def step_banner(t: int, n: int, time_value: float, label: str = "Time") -> None:
    print(f" ==== Step {t:4d} out of {n:4d} ({label}={time_value:9g}) ==== ")


class PerfLog:
    """Phase timer printed at exit (the role of the C++ reference's
    libMesh PerfLog, src/main.C:7,59).  A phase that launches device work
    ends when that work is done only where the code syncs: the solvers
    read their residuals back every iteration."""

    def __init__(self, name: str = "rdcfes_tpu_torch"):
        self.name = name
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def scope(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[label] += dt
            self.counts[label] += 1

    def report(self, out=None) -> None:
        if out is None:
            out = sys.stdout  # call-time stream, not import-time
        total = sum(self.totals.values())
        print(f"\n Performance log: {self.name}", file=out)
        print(f" {'phase':<28}{'calls':>8}{'total s':>12}{'avg ms':>12}", file=out)
        for label in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[label]
            tt = self.totals[label]
            print(f" {label:<28}{n:>8}{tt:>12.4f}{1e3 * tt / max(n, 1):>12.3f}",
                  file=out)
        print(f" {'TOTAL':<28}{'':>8}{total:>12.4f}", file=out)


def make_solid_device_mesh(deck) -> Optional[int]:
    """The solid's `device_mesh` from the deck key `parallel/n_devices`:
    its shard count D when D > 1 (SolidSystem then runs the halo Newton,
    parallel/solid_halo.py, on D shards), else None (the reference's
    make_solid_device_mesh, rdcfes_tpu/drivers/common.py:171-189, which
    builds a DeviceMesh of D devices)."""
    n_dev = int(deck("parallel/n_devices", 0))
    return n_dev if n_dev > 1 else None


class Remeshed(NamedTuple):
    """One remeshing pass: the new mesh, the nodal prolongation and the
    elemental transfer old -> new, and the hanging-node rows [h, a, b]
    of the new mesh ((0, 3) unless it is a remeshed MixedMesh)."""

    mesh: object
    prolong: Callable[[np.ndarray], np.ndarray]
    elemental: Callable[[np.ndarray], np.ndarray]
    constraints: np.ndarray


class Remesher:
    """The remeshing of the solid and coupled HCC drivers (rdcfes_tpu/
    drivers/solid.py:216-369, rdcfes_tpu/drivers/coupled_hcc.py:
    259-385; C++ src/solid.C:330-369, src/coupled_hcc.C:733-780): the
    Kelly indicator of two nodal fields, libMesh's mean-stddev flags,
    then by mesh type

    * MIXED: the TET4 block refined 1:8 against the frozen transition
      blocks, with hanging nodes (mesh/adapt_ext.MixedConstrained);
    * TET4: selective bisection refine and coarsen (mesh/adapt.py);
    * TET10, when `tet10_bisection` (the solid's): skeleton bisection
      with the exact quadratic transfer (adapt_ext.Tet10Adaptive);
    * otherwise the uniform conforming refinement (mesh/refine.py),
      which takes HEX8 and raises ValueError on TET10, as the
      reference's does in the HCC driver.

    The adaptive state (the bisection forest, the hanging set) lives
    across passes while the mesh it adapted is the current one; its
    hanging-node rows (`constraints`) are the ones the drivers' systems
    take.  A checkpoint written after remeshing holds the refined mesh
    (`checkpoint_mesh.msh` beside it, and its coordinates at full
    precision as `mesh_coords`, which the reference's resume ignores: the
    Gmsh file has 6 significant digits), `amr_done`, the fibres and the
    hanging-node rows (`checkpoint_extras`, `resume`)."""

    CHECKPOINT_MESH = "checkpoint_mesh.msh"

    def __init__(self, refine_fraction: float, coarsen_fraction: float,
                 max_level: int, tet10_bisection: bool):
        self.refine_fraction = refine_fraction
        self.coarsen_fraction = coarsen_fraction
        self.max_level = max_level
        self.tet10_bisection = tet10_bisection
        self.adaptive = None

    @property
    def constraints(self) -> np.ndarray:
        """The hanging-node rows [h, a, b] of the current mesh: those of
        the last MixedMesh adapted, else (0, 3)."""
        if isinstance(self.adaptive, MixedConstrained):
            return self.adaptive.constraints
        return np.zeros((0, 3), dtype=np.int64)

    def resume(self, ckpt_path: str, extra: dict, mesh, fibres):
        """(mesh, fibres, amr_done) to go on from a checkpoint's `extra`:
        the refined mesh, its fibres and its pass count when it was
        written after remeshing (a MixedMesh's hanging set restored, so
        that a later pass refines on it), else the inputs and 0."""
        ck_mesh = os.path.join(os.path.dirname(ckpt_path),
                               self.CHECKPOINT_MESH)
        if "amr_done" not in extra or not os.path.exists(ck_mesh):
            return mesh, fibres, 0
        mesh = gmsh.read(ck_mesh)
        if "mesh_coords" in extra:
            mesh.coords = np.ascontiguousarray(extra["mesh_coords"])
        if len(extra.get("constraints", ())):
            self.adaptive = MixedConstrained.from_mesh(mesh)
            self.adaptive.hanging = {(int(a), int(b)): int(h)
                                     for h, a, b in extra["constraints"]}
        return mesh, extra["fibres"], int(extra["amr_done"])

    def checkpoint_extras(self, directory: str, mesh, amr_done: int) -> dict:
        """The arrays a checkpoint holds after `amr_done` passes beside
        the state, the refined mesh written into `directory`; {} before
        the first pass."""
        if not amr_done:
            return {}
        gmsh.write(mesh, os.path.join(directory, self.CHECKPOINT_MESH))
        extras = {"amr_done": np.asarray(amr_done), "mesh_coords": mesh.coords}
        if len(self.constraints):
            # the refined mesh is nonconforming without them
            extras["constraints"] = self.constraints
        return extras

    def remesh(self, step: int, mesh, indicator: np.ndarray
               ) -> Optional[Remeshed]:
        """adapt(), with the drivers' line on what it did."""
        r = self.adapt(mesh, indicator)
        if r is None:
            print(f"remeshing step {step}: nothing flagged")
            return None
        hanging = (f" ({len(r.constraints)} hanging constraints)"
                   if r.mesh.elem_type == "MIXED" else "")
        print(f"remeshing step {step}: adapted to {r.mesh.n_elems} "
              f"elements{hanging}")
        return r

    def adapt(self, mesh, indicator: np.ndarray) -> Optional[Remeshed]:
        """One pass on `mesh` driven by indicator (N, 2); None when
        nothing was flagged."""
        kelly = kelly_mixed if mesh.elem_type == "MIXED" else \
            kelly_error_indicator
        flags, coarsen = flag_by_mean_stddev(
            kelly(mesh, indicator, [0, 1]), self.refine_fraction,
            self.coarsen_fraction)
        none = np.zeros((0, 3), dtype=np.int64)
        make = {"MIXED": MixedConstrained.from_mesh, "TET4": AdaptiveMesh}
        if self.tet10_bisection:
            make["TET10"] = Tet10Adaptive.from_mesh
        if mesh.elem_type not in make:
            r = refine_flagged(mesh, flags)
            return None if r is None else Remeshed(
                r.mesh, r.prolong, r.restrict_elemental, none)
        if getattr(self.adaptive, "mesh", None) is not mesh:
            self.adaptive = make[mesh.elem_type](mesh)
        if mesh.elem_type == "MIXED":
            r = self.adaptive.refine_and_coarsen(flags, coarsen,
                                                 max_level=self.max_level)
            if r is None:
                return None
            self.adaptive = r.constrained
            return Remeshed(r.mesh, r.prolong, r.transfer_elemental,
                            r.constraints)
        r = adapt_flagged(self.adaptive, flags, coarsen,
                          max_level=self.max_level)
        if r is None:
            return None
        self.adaptive = r.adaptive
        return Remeshed(r.mesh, r.prolong, r.restrict_elemental, none)


def make_rdc_system(mesh, n_vars: int, physics_blocks: Callable, deck, *,
                    clamp: Optional[Callable] = None, device=None,
                    **kw):
    """The transient system a driver steps, with the reference drivers'
    settings: precision "f64", method "bicgstab", precond_refresh 1, and
    rtol from the deck key `solver/linear/tolerance` (default 3e-11, the
    value the reference calibrated against its direct-solve oracles,
    rdcfes_tpu/drivers/common.py:98-111).  A MixedMesh gets a
    MixedTransientRDCSystem with precision "mixed", as the reference's
    (rdcfes_tpu/drivers/common.py:110-130).  device None is the CUDA card.

    `parallel/n_devices` = D > 1 gives the halo-exchange system on D
    shards (parallel.halo.HaloShardedSystem, placed by
    parallel.halo.shard_devices from `device`), with the deck's rtol, the
    clamp and the hanging-node constraints, on a single-type mesh or a
    MixedMesh: the reference's (rdcfes_tpu/drivers/common.py:109-159).
    With `moving_mesh=True` it runs the moving mesh on the D shards
    (coords= in step and run_steps), as the coupled HCC driver asks.

    Every system it returns answers initial_state, gather (a state entry
    as the global (N, V) host array), gather_state and scatter_state: the
    reference's get_u and put_state."""
    n_dev = int(deck("parallel/n_devices", 0))
    kw.setdefault("rtol", float(deck("solver/linear/tolerance", 3e-11)))
    if clamp is not None:
        kw["clamp"] = clamp
    if n_dev > 1:
        halo_kw = {k: kw[k] for k in ("rtol", "clamp", "constraints",
                                      "maxiter", "ops", "physics",
                                      "moving_mesh") if k in kw}
        return HaloShardedSystem(mesh, n_vars, n_dev, physics_blocks,
                                 device=device, **halo_kw)
    kw.setdefault("method", "bicgstab")
    kw.setdefault("precond_refresh", 1)
    if mesh.elem_type == "MIXED":
        kw["precision"] = "mixed"
        return MixedTransientRDCSystem(mesh, n_vars, physics_blocks,
                                       device=device, **kw)
    kw.setdefault("precision", "f64")
    return TransientRDCSystem(mesh, n_vars, physics_blocks, device=device,
                              **kw)
