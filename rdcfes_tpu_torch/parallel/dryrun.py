"""The quickest multi-device smoke: one PIHNA step of box_tet_mesh(8)
(729 nodes, 3,072 TET4) on n shards, the counterpart of the reference's
dryrun_multichip (__graft_entry__.py:77-107).

    python3 -m rdcfes_tpu_torch.parallel.dryrun [n] [cpu]
"""

from __future__ import annotations

import sys

import numpy as np


def small_case(n: int = 8):
    """(mesh, params, u0) of the reference's _small_case: PIHNA on
    box_tet_mesh(n), dt 0.1, random seeded cells."""
    from ..mesh import box_tet_mesh
    from ..models.pihna import default_params

    mesh = box_tet_mesh(n, n, n)
    Kk = 2.39e5
    params = default_params()
    params.update(
        dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
        cells_max_capacity_exponent=3.0, cytokines_max_capacity=1.0e-8,
        necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk, necrosis_v=300.0 / Kk,
        produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82, switch_h2n=0.5,
        diffuse_v=0.5, produce_v=10.0,
        secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, decay_a=5678.4,
    )
    rng = np.random.default_rng(0)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 0.1 * Kk * rng.random(mesh.n_nodes)
    u0[:, 3] = 0.03 * Kk
    u0[:, 4] = 1e-9
    return mesh, params, u0


def dryrun_multichip(n: int, device=None) -> str:
    """One PIHNA step (the dense path, as the reference's dryrun) on n
    shards placed by parallel.halo.shard_devices (device None: the card).
    Returns the report line; raises AssertionError on a non-finite state
    or a residual above 1e-8."""
    from ..models.pihna import pihna_physics
    from .halo import HaloShardedSystem

    mesh, params, u0 = small_case(8)
    system = HaloShardedSystem(mesh, 5, n, physics=pihna_physics,
                               device=device)
    state = system.initial_state(u0)
    state, iters, res = system.step(state, params=params)
    u = system.gather(state["u"])
    assert np.isfinite(u).all()
    assert float(res) < 1e-8
    return (f"dryrun_multichip({n}): ok - {int(iters)} Krylov iters, "
            f"residual {float(res):.2e}")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    print(dryrun_multichip(n, sys.argv[2] if len(sys.argv) > 2 else None))
