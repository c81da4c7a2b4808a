"""Shared driver plumbing: output schedules, step banners, the phase log,
the optional profiler trace, and the transient system a driver steps."""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Optional, Set

import torch

from ..io.getpot import export_integers
from ..systems import MixedTransientRDCSystem, TransientRDCSystem

_MULTI = "ROADMAP queue 1 item 14 (multi-device)"
_ITEM13 = "ROADMAP queue 1 item 13"


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


def require_one_device(deck) -> None:
    """Deck key `parallel/n_devices` (the reference's multi-chip halo
    systems): only 0 or 1 is ported."""
    n_dev = int(deck("parallel/n_devices", 0))
    if n_dev > 1:
        raise NotImplementedError(f"parallel/n_devices = {n_dev}: {_MULTI}")


def require_first_order_tet_or_hex(mesh, what: str) -> None:
    """The drivers that run only on single-type TET4 and HEX8 meshes (the
    solid and HCC) raise NotImplementedError on a MIXED or TET10 mesh,
    before the first step."""
    if mesh.elem_type not in ("TET4", "HEX8"):
        raise NotImplementedError(
            f"{what} on a {mesh.elem_type} mesh: {_ITEM13}, sub-slices 4 "
            "and 5 (the solid and HCC on mixed and TET10 meshes)")


def make_rdc_system(mesh, n_vars: int, physics_blocks: Callable, deck, *,
                    clamp: Optional[Callable] = None, device=None,
                    **kw) -> TransientRDCSystem:
    """The transient system a driver steps, with the reference drivers'
    settings: precision "f64", method "bicgstab", precond_refresh 1, and
    rtol from the deck key `solver/linear/tolerance` (default 3e-11, the
    value the reference calibrated against its direct-solve oracles,
    rdcfes_tpu/drivers/common.py:98-111).  A MixedMesh gets a
    MixedTransientRDCSystem with precision "mixed", as the reference's
    (rdcfes_tpu/drivers/common.py:110-130).  device None is the CUDA card.
    `parallel/n_devices` > 1 raises NotImplementedError."""
    require_one_device(deck)
    kw.setdefault("rtol", float(deck("solver/linear/tolerance", 3e-11)))
    kw.setdefault("method", "bicgstab")
    kw.setdefault("precond_refresh", 1)
    if clamp is not None:
        kw["clamp"] = clamp
    if mesh.elem_type == "MIXED":
        kw["precision"] = "mixed"
        return MixedTransientRDCSystem(mesh, n_vars, physics_blocks,
                                       device=device, **kw)
    kw.setdefault("precision", "f64")
    return TransientRDCSystem(mesh, n_vars, physics_blocks, device=device,
                              **kw)
