"""The moving mesh on several devices (rdcfes_tpu_torch/parallel/halo.py,
`moving_mesh=True` and `coords=` in step and run_steps) on the CPU
(`device="cpu"`: every shard on the CPU):

* against the reference's HaloShardedSystem(moving_mesh=True) on the
  first 4 of the 8 virtual devices (tests/conftest.py), TET4 box 3^3
  with the HCC model (the port's hcc_blocks, the reference's
  hcc_physics, whose moving step is the dense path), 3 steps at rtol
  1e-13: within 1e-10 relative L2 a step;
* against the port's single-device moving system (TransientRDCSystem, or
  MixedTransientRDCSystem in f64), 3 steps at rtol 1e-13, within 1e-8
  (the reference's bar, tests/test_halo.py:342-378, tests/
  test_mixed.py:497-534) on TET4, HEX8, TET10, MIXED, TET4 with hanging
  nodes, and TET4 on the dense path;
* run_steps(coords=) against per-step step(coords=) within 1e-11, and
  the per-shard geometry against the one built on the whole mesh."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

from rdcfes_tpu.models.hcc import hcc_physics as jhcc_physics
from rdcfes_tpu.parallel.halo import HaloShardedSystem as JHalo

from rdcfes_tpu_torch.mesh import (ConstrainedMesh, box_hex_mesh,
                                   box_mixed_mesh, box_tet_mesh,
                                   tet4_to_tet10)
from rdcfes_tpu_torch.models.hcc import (default_params, hcc_blocks,
                                         hcc_physics)
from rdcfes_tpu_torch.parallel import HaloShardedSystem
from rdcfes_tpu_torch.systems import (MixedTransientRDCSystem,
                                      TransientRDCSystem)

from tests.torch_helpers import quick_compile, reference_native_rcb, rel_l2

RTOL = 1e-13


def hcc_case(mesh):
    """(plain-float params, u0 (N, 3), moved coords) of the reference's
    moving halo tests (tests/test_halo.py:342-378) on `mesh`."""
    r2 = ((mesh.coords - 0.5) ** 2).sum(axis=1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 0.3 * np.exp(-r2 / 0.05)
    u0[:, 2] = 0.1 * np.exp(-r2 / 0.08)
    p = default_params()
    p.update(dt=0.05, diffuse_c=1e-3, produce_c=0.2, cells_max_capacity=1.0)
    coords = mesh.coords + 0.03 * np.sin(mesh.coords * 3.0)
    return {k: float(v) for k, v in p.items()}, u0, coords


def hanging_mesh():
    """box_tet_mesh(3) with 12 elements refined 1:8: (mesh, rows)."""
    mesh = box_tet_mesh(3, 3, 3)
    flags = np.zeros(mesh.n_elems, bool)
    flags[:12] = True
    r = ConstrainedMesh(mesh).refine_and_coarsen(
        flags, np.zeros(mesh.n_elems, bool), max_level=2)
    return r.constrained.mesh, r.constrained.constraints


def test_moving_halo_matches_reference(tmp_path):
    mesh = box_tet_mesh(3, 3, 3)
    p, u0, coords = hcc_case(mesh)
    dmesh = DeviceMesh(np.array(jax.devices()[:4]), ("d",))
    with reference_native_rcb(tmp_path), quick_compile():
        ref = JHalo(mesh, 3, jhcc_physics, dmesh, rtol=RTOL,
                    moving_mesh=True)
        st = ref.initial_state(u0)
        want = []
        for _ in range(3):
            st, it, _ = ref.step(st, params=p, coords=coords)
            want.append((ref.gather(st["u"]), int(it)))
    h = HaloShardedSystem(mesh, 3, 4, hcc_blocks, rtol=RTOL,
                          moving_mesh=True, device="cpu")
    np.testing.assert_array_equal(h.plan.node_order, ref.plan.node_order)
    s = h.initial_state(u0)
    for u_ref, it_ref in want:
        s, it, res = h.step(s, params=p, coords=coords)
        assert rel_l2(h.gather(s["u"]), u_ref) <= 1e-10
        assert abs(it - it_ref) <= 1 and float(res) <= RTOL


def _mesh(kind):
    if kind == "tet4 hanging":
        return hanging_mesh()
    return {"tet4": lambda: box_tet_mesh(3, 3, 3),
            "tet4 dense": lambda: box_tet_mesh(3, 3, 3),
            "hex8": lambda: box_hex_mesh(3, 3, 3),
            "tet10": lambda: tet4_to_tet10(box_tet_mesh(2, 2, 2)),
            "mixed": lambda: box_mixed_mesh(5, 3, 3)}[kind](), None


@pytest.mark.parametrize("kind", ["tet4", "hex8", "tet10", "mixed",
                                  "tet4 hanging", "tet4 dense"])
def test_moving_halo_matches_one_device(kind):
    mesh, cons = _mesh(kind)
    p, u0, coords = hcc_case(mesh)
    blocks = None if kind == "tet4 dense" else hcc_blocks
    kw = dict(rtol=RTOL, moving_mesh=True, constraints=cons, device="cpu",
              physics=hcc_physics)
    cls = (MixedTransientRDCSystem if kind == "mixed"
           else TransientRDCSystem)
    one = cls(mesh, 3, blocks, **kw)
    h = HaloShardedSystem(mesh, 3, 4, blocks, **kw)
    a, b = h.initial_state(u0), one.initial_state(u0)
    xt = torch.as_tensor(coords)
    for _ in range(3):
        a, _, res = h.step(a, params=p, coords=xt)
        b, _, _ = one.step(b, params=p, coords=xt)
        assert rel_l2(h.gather(a["u"]), b["u"].numpy()) <= 1e-8
        assert float(res) <= RTOL
    if cons is not None:
        u = h.gather(a["u"])
        hh, aa, bb = cons.T
        np.testing.assert_allclose(u[hh], 0.5 * (u[aa] + u[bb]), rtol=0,
                                   atol=1e-12)


def test_moving_run_steps_matches_step():
    """run_steps(coords=) (the geometry built once) against three
    step(coords=) calls on the mixed mesh; scatter_coords caches by
    identity, and the shards' geometry is the whole mesh's, element for
    element."""
    mesh = box_mixed_mesh(5, 3, 3)
    p, u0, coords = hcc_case(mesh)
    a, b = (HaloShardedSystem(mesh, 3, 3, hcc_blocks, rtol=RTOL,
                              moving_mesh=True, device="cpu")
            for _ in range(2))
    sa, sb = a.initial_state(u0), b.initial_state(u0)
    for _ in range(3):
        sa, _, _ = a.step(sa, params=p, coords=coords)
    sb, its, ress = b.run_steps(sb, 3, params=p, coords=coords)
    assert its.shape == (3,) and ress.shape == (3,)
    assert np.abs(a.gather(sa["u"]) - b.gather(sb["u"])).max() <= 1e-11
    assert b.scatter_coords(coords) is b.scatter_coords(coords)
    assert b.scatter_coords(coords.copy()) is not b.scatter_coords(coords)
    with pytest.raises(ValueError, match="coords"):
        b.step(sb, params=p)
    fixed = HaloShardedSystem(mesh, 3, 3, hcc_blocks, device="cpu")
    moved = fixed.moving_geometry(mesh.coords)
    for s, sh in enumerate(fixed.shards):
        for (_, _, g), gm in zip(sh.parts, moved[s]):
            torch.testing.assert_close(gm.JxW, g.JxW, rtol=1e-14, atol=0)
            torch.testing.assert_close(gm.dphi, g.dphi, rtol=1e-14,
                                       atol=1e-300)
