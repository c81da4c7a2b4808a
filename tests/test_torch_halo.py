"""The port's multi-device halo system (rdcfes_tpu_torch/parallel/halo.py)
against rdcfes_tpu/parallel/halo.py and against the port's single-device
system, on the CPU (`device="cpu"`: every shard on the CPU):

* partition_rcb (the native RCB) equals the reference's C++ RCB on box
  meshes' centroids, ties included;
* every HaloPlan array equals the reference's, with and without
  hanging-node constraints;
* scatter_nodal / gather round-trip exactly;
* one reference HaloShardedSystem run on the 8 virtual devices (TET4 5^3,
  the qp path, rtol 1e-13) against the port's: within 1e-10 relative L2
  over 3 steps, the inner iterations within 1;
* the port's halo system against its single-device system within 1e-8
  over 5 steps on TET4 (qp and dense), HEX8 (qp) and a TET4 mesh with
  hanging nodes; run_steps against per-step step within 1e-11;
* the placement rule of the shards, the exchanges of ShardGroup, and
  the moving mesh (coords=) on 2 shards against the single-device
  moving system (every type: tests/test_torch_halo_moving.py).

Both packages partition through the same C++ RCB: the reference's
NumPy fallback splits equal centroids in another order, so the module
builds the reference's rdcfes_tpu/native/meshkit.cpp with the host g++
into a temporary directory and points the reference's loader at it for
the module's tests."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

import rdcfes_tpu.native as jnative
from rdcfes_tpu.mesh import box_tet_mesh as jbox_tet_mesh
from rdcfes_tpu.models.pihna import pihna_blocks as jpihna_blocks
from rdcfes_tpu.models.pihna import pihna_physics as jpihna_physics
from rdcfes_tpu.parallel.halo import HaloPlan as JHaloPlan
from rdcfes_tpu.parallel.halo import HaloShardedSystem as JHalo

from rdcfes_tpu_torch.fem.kernels import PLAIN_OPS
from rdcfes_tpu_torch.mesh import (ConstrainedMesh, box_hex_mesh,
                                   box_mixed_mesh, box_tet_mesh)
from rdcfes_tpu_torch.models.pihna import (default_params, pihna_blocks,
                                           pihna_physics)
from rdcfes_tpu_torch.native import partition_rcb
from rdcfes_tpu_torch.parallel import (HaloPlan, HaloShardedSystem,
                                       ShardGroup, shard_devices)
from rdcfes_tpu_torch.systems import TransientRDCSystem

from tests.torch_helpers import quick_compile, reference_native_rcb, rel_l2


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's meshkit C++ built and loaded by rdcfes_tpu.native
    for the module's tests (its NumPy RCB splits ties otherwise)."""
    with reference_native_rcb(tmp_path_factory.mktemp("ref_meshkit")):
        yield


def pihna_case(mesh):
    """(plain-float params, u0 (N, 5)) of the reference's halo tests
    (tests/test_halo.py _pihna_case) on `mesh`."""
    Kk = 2.39e5
    p = default_params()
    p.update(
        dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
        cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
        necrosis_c=500 / Kk, necrosis_h=200 / Kk, necrosis_v=300 / Kk,
        produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82, switch_h2n=0.5,
        diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0, taxis_h=4e-5,
        diffuse_v=0.2, taxis_v=1e-4, produce_v=10.0,
        secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, uptake_a_v=1e-3,
        decay_a=5678.4)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 0] = 5 * np.exp(-r2 / 2)
    u0[:, 1] = 2000 * np.exp(-r2 / 3)
    u0[:, 2] = 500 * np.exp(-r2 / 2.5)
    u0[:, 3] = 7200 * np.exp(-r2 / 20)
    u0[:, 4] = 1e-10
    return {k: float(v) for k, v in p.items()}, u0


def constrained_mesh():
    """box_tet_mesh(3) with 12 elements refined 1:8 (hanging nodes):
    (mesh, rows [h, a, b])."""
    mesh = box_tet_mesh(3, 3, 3)
    flags = np.zeros(mesh.n_elems, bool)
    flags[:12] = True
    r = ConstrainedMesh(mesh).refine_and_coarsen(
        flags, np.zeros(mesh.n_elems, bool), max_level=2)
    return r.constrained.mesh, r.constrained.constraints


@pytest.mark.parametrize("D", [2, 3, 4, 8])
@pytest.mark.parametrize("mesh", ["tet4", "hex8"])
def test_partition_rcb_matches_reference(ref_native, mesh, D):
    m = box_tet_mesh(5, 5, 5) if mesh == "tet4" else box_hex_mesh(6, 6, 6)
    centers = m.coords[m.connectivity].mean(axis=1)
    part = partition_rcb(centers, D)
    np.testing.assert_array_equal(part, jnative.partition_rcb(centers, D))
    # equal shards: RCB's quantile splits
    counts = np.bincount(part, minlength=D)
    assert counts.max() - counts.min() <= 1


@pytest.mark.parametrize("D", [2, 3, 8])
@pytest.mark.parametrize("with_cons", [False, True])
def test_halo_plan_matches_reference(ref_native, with_cons, D):
    if with_cons:
        mesh, cons = constrained_mesh()
    else:
        mesh, cons = box_tet_mesh(5, 5, 5), None
    got = HaloPlan.build(mesh, D, constraints=cons)
    want = JHaloPlan.build(mesh, D, constraints=cons)
    assert got.has_cons == want.has_cons == with_cons
    for name, w in vars(want).items():
        g = getattr(got, name)
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)
                assert a.dtype == b.dtype, name
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert g.dtype == w.dtype, name
        else:
            assert g == w, name


def test_scatter_gather_roundtrip():
    mesh = box_tet_mesh(4, 4, 4)
    _, u0 = pihna_case(mesh)
    h = HaloShardedSystem(mesh, 5, 3, pihna_blocks, device="cpu")
    st = h.initial_state(u0)
    assert [tuple(x.shape) for x in st["u"]] == [(5, h.plan.No_max)] * 3
    np.testing.assert_array_equal(h.gather(st["u"]), u0)
    back = h.scatter_state(h.gather_state(st))
    for k in st:
        for a, b in zip(back[k], st[k]):
            assert torch.equal(a, b)
    # an elemental field follows the element partition
    ids = np.arange(mesh.n_elems, dtype=np.float64)
    parts = h.shard_elem_field(np.stack([ids, -ids], axis=1), axis=0)
    flat = torch.cat(parts).numpy()
    np.testing.assert_array_equal(flat[:, 0], h.plan.elem_order)
    np.testing.assert_array_equal(h.processor_id[h.plan.elem_order],
                                  np.repeat(np.arange(3),
                                            h.plan.elem_counts))


@pytest.fixture(scope="module")
def reference_halo_run(ref_native):
    """The reference's qp-path HaloShardedSystem on the 8 virtual devices
    (TET4 5^3, rtol 1e-13): 3 steps' (u, iterations)."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.fail("tests/conftest.py provides 8 virtual CPU devices")
    mesh = jbox_tet_mesh(5, 5, 5)
    p, u0 = pihna_case(mesh)
    sysj = JHalo(mesh, 5, jpihna_physics, DeviceMesh(np.array(devs[:8]),
                                                     ("d",)),
                 physics_blocks=jpihna_blocks, rtol=1e-13)
    st = sysj.initial_state(u0)
    out = []
    with quick_compile():
        for _ in range(3):
            st, it, _ = sysj.step(st, params=p)
            out.append((sysj.gather(st["u"]), int(it)))
    return out


def test_halo_step_matches_reference(reference_halo_run):
    mesh = box_tet_mesh(5, 5, 5)
    p, u0 = pihna_case(mesh)
    h = HaloShardedSystem(mesh, 5, 8, pihna_blocks, rtol=1e-13,
                          device="cpu")
    st = h.initial_state(u0)
    for u_ref, it_ref in reference_halo_run:
        st, it, res = h.step(st, params=p)
        assert rel_l2(h.gather(st["u"]), u_ref) <= 1e-10
        assert abs(it - it_ref) <= 1
        assert float(res) <= 1e-13


@pytest.mark.parametrize("case", ["tet4 qp", "tet4 dense", "hex8 qp",
                                  "tet4 hanging"])
def test_halo_matches_single_device(case):
    cons = None
    if case == "tet4 hanging":
        mesh, cons = constrained_mesh()
    elif case.startswith("hex8"):
        mesh = box_hex_mesh(4, 4, 4)
    else:
        mesh = box_tet_mesh(3, 3, 3)
    p, u0 = pihna_case(mesh)
    kw = ({"physics": pihna_physics} if case.endswith("dense")
          else {"physics_blocks": pihna_blocks})
    h = HaloShardedSystem(mesh, 5, 3, rtol=1e-12, constraints=cons,
                          device="cpu", **kw)
    s = TransientRDCSystem(mesh, 5, rtol=1e-12, constraints=cons,
                           device="cpu", **kw)
    if cons is not None:
        assert h.plan.has_cons and any(sh.cons is not None
                                       for sh in h.shards)
    a, b = h.initial_state(u0), s.initial_state(u0)
    for _ in range(5):
        a, _, res = h.step(a, params=p)
        b, _, _ = s.step(b, params=p)
        assert rel_l2(h.gather(a["u"]), b["u"].numpy()) <= 1e-8
        assert rel_l2(h.gather(a["u_raw"]), b["u_raw"].numpy()) <= 1e-8
        assert float(res) <= 1e-12


def test_run_steps_matches_step():
    mesh = box_tet_mesh(3, 3, 3)
    p, u0 = pihna_case(mesh)
    h = HaloShardedSystem(mesh, 5, 2, pihna_blocks, device="cpu",
                          ops=PLAIN_OPS)
    a = b = h.initial_state(u0)
    a, its, ress = h.run_steps(a, 3, params=p)
    per = []
    for _ in range(3):
        b, it, _ = h.step(b, params=p)
        per.append(it)
    assert its.tolist() == per and ress.shape == (3,)
    assert rel_l2(h.gather(a["u"]), h.gather(b["u"])) <= 1e-11
    # field_update and scalar_traj reach each step
    seen = []

    def update(st, aux, tr):
        seen.append((tr["k"], aux))
        return {}, aux + 1

    *_, aux = h.run_steps(h.initial_state(u0), 2, params=p,
                          scalar_traj={"k": [5.0, 6.0]},
                          field_update=update, field_aux=0)
    assert seen == [(5.0, 0), (6.0, 1)] and aux == 2


def test_placement_rule(monkeypatch):
    """The CPU gives every shard the CPU; a card gives shard s the card
    (index + s) mod count, so one card takes every shard; None is the
    card, and raises without one, never the CPU."""
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    one = shard_devices(4, "cuda", cuda_count=1)
    assert one == [torch.device("cuda", 0)] * 4
    assert shard_devices(4, "cuda:1", cuda_count=2) == [
        torch.device("cuda", i) for i in (1, 0, 1, 0)]
    assert shard_devices(3, torch.device("cuda", 0), cuda_count=4) == [
        torch.device("cuda", i) for i in (0, 1, 2)]
    with pytest.raises(ValueError):
        shard_devices(2, "meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_devices(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HaloShardedSystem(box_tet_mesh(2, 2, 2), 5, 2, pihna_blocks)


def test_shard_group_collectives():
    g = ShardGroup(["cpu"] * 3)
    bufs = [torch.full((2,), float(i)) for i in range(3)]
    assert [b[0].item() for b in g.ppermute(bufs, 1)] == [2.0, 0.0, 1.0]
    assert [b[0].item() for b in g.ppermute(bufs, -1)] == [1.0, 2.0, 0.0]
    vals = [torch.tensor(x, dtype=torch.float64) for x in (1e16, 1.0, -1e16)]
    assert g.psum(vals).item() == (1e16 + 1.0) - 1e16  # shard order


def test_unported_raise():
    """The moving mesh, which raised until it was ported, runs:
    moving_mesh=True with coords= in step and run_steps on 2 shards
    matches the single-device moving system within 1e-8, and a moving
    system stepped without coords raises ValueError, as the
    single-device one does.  MIXED meshes, which raised until they were
    ported, build (tests/test_torch_halo_ext.py holds them)."""
    assert HaloShardedSystem(box_mixed_mesh(3, 1, 1), 5, 2, pihna_blocks,
                             device="cpu").n_blocks == 3
    mesh = box_tet_mesh(2, 2, 2)
    p, u0 = pihna_case(mesh)
    coords = mesh.coords + 0.05 * np.sin(mesh.coords)
    h = HaloShardedSystem(mesh, 5, 2, pihna_blocks, device="cpu",
                          moving_mesh=True)
    one = TransientRDCSystem(mesh, 5, pihna_blocks, device="cpu",
                             moving_mesh=True)
    st = h.initial_state(u0)
    want = one.step(one.initial_state(u0), params=p,
                    coords=torch.as_tensor(coords))[0]["u"].numpy()
    for out in (h.step(st, params=p, coords=coords),
                h.run_steps(st, 1, params=p, coords=coords)):
        assert rel_l2(h.gather(out[0]["u"]), want) <= 1e-8
    with pytest.raises(ValueError, match="coords"):
        h.step(st, params=p)