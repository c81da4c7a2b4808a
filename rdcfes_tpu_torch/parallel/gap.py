"""How far two solves of a generated mixed case part, step by step: the
case stepped through the halo system on 4 shards (f64 BiCGStab), through
MixedTransientRDCSystem in f64 and through MixedTransientRDCSystem in
mixed precision, all at one rtol, from the case's own deck and initial
conditions.  Each step prints the three solves' inner iterations and
residuals, then per species the largest gap over 1 + the largest value
(the multi-device bar's measure) between the halo and the f64 run, and
between the mixed-precision and the f64 run.

    python3 -m rdcfes_tpu_torch.parallel.gap {pihna|adpm} [n] [rtol] [steps] [cpu]

n (default 28) sizes make_*_case(n, mixed=True); ADPM runs at the taxis
amplitude 50 (the watch-list's), its `time` advancing by dt.  Without
`cpu` it runs on the card, and raises without one.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch


def _case(model: str, n: int, steps: int):
    """(mesh, u0, fields, params, n_vars, blocks) of the mixed case."""
    from .. import cases
    from ..drivers import adpm, pihna
    from ..io import dat
    from ..io.getpot import Deck
    from ..mesh import gmsh
    from ..models.adpm import adpm_blocks
    from ..models.pihna import pihna_blocks

    with tempfile.TemporaryDirectory(prefix="rdcfes_gap_") as d:
        make = (cases.make_adpm_case if model == "adpm"
                else cases.make_pihna_case)
        make(d, n=n, n_steps=steps, mixed=True)
        path = os.path.join(d, "input.dat")
        if model == "adpm":
            text = open(path).read().replace("0.999999e+3", "50.0")
            with open(path, "w") as f:
                f.write(text)
        deck = Deck(path)
        read = lambda key, rows, cols: dat.read_stream(
            os.path.join(d, deck(key, "")), rows, cols)
        mesh = gmsh.read(os.path.join(d, deck("input_GMSH", "")))
        if model == "adpm":
            return (mesh, read("input_nodal", mesh.n_nodes, 3),
                    read("input_elemental", mesh.n_elems, 3),
                    adpm.load_params(deck), 3, adpm_blocks)
        return (mesh, read("input_nodal", mesh.n_nodes, 5), None,
                pihna.load_params(deck), 5, pihna_blocks)


def main(argv=None) -> int:
    from ..systems import MixedTransientRDCSystem
    from ..utils.device import cuda_device
    from .halo import HaloShardedSystem

    args = list(sys.argv[1:] if argv is None else argv)
    model = args[0]
    n = int(args[1]) if len(args) > 1 else 28
    rtol = float(args[2]) if len(args) > 2 else 1e-12
    steps = int(args[3]) if len(args) > 3 else 20
    dev = (torch.device("cpu") if len(args) > 4 and args[4] == "cpu"
           else cuda_device())
    mesh, u0, tracts, params, V, blocks = _case(model, n, steps)
    halo = HaloShardedSystem(mesh, V, 4, blocks, rtol=rtol, device=dev)
    f64, mixed = (MixedTransientRDCSystem(mesh, V, blocks, rtol=rtol,
                                          precision=p, device=dev)
                  for p in ("f64", "mixed"))
    fh = fo = {}
    if tracts is not None:
        fh = {"tracts": halo.shard_elem_field(tracts, axis=0)}
        fo = {"tracts": torch.as_tensor(tracts, device=dev)}
    a, b, c = (s.initial_state(u0) for s in (halo, f64, mixed))

    def gap(x, y):
        return np.abs(x - y).max(axis=0) / (1.0 + np.abs(y).max(axis=0))

    print(f"{model} mixed n={n} rtol={rtol} on {dev}: step, iterations "
          f"and residuals (halo, f64, mixed), then per species gap "
          f"halo-f64 and mixed-f64")
    for k in range(1, steps + 1):
        sc = {"time": params["dt"] * k} if tracts is not None else None
        a, ia, ra = halo.step(a, fields=fh, scalars=sc, params=params)
        b, ib, rb = f64.step(b, fields=fo, scalars=sc, params=params)
        c, ic, rc = mixed.step(c, fields=fo, scalars=sc, params=params)
        ua, ub, uc = (halo.gather(a["u"]), b["u"].cpu().numpy(),
                      c["u"].cpu().numpy())
        print(k, int(ia), int(ib), int(ic),
              " ".join(f"{float(r):.2e}" for r in (ra, rb, rc)),
              "halo-f64", " ".join(f"{g:.2e}" for g in gap(ua, ub)),
              "mixed-f64", " ".join(f"{g:.2e}" for g in gap(uc, ub)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
