"""The port's multi-device halo system (rdcfes_tpu_torch/parallel/halo.py)
on every element type and on a MixedMesh, on the CPU (`device="cpu"`:
every shard on the CPU):

* build_mixed_plan equals the reference's (the node-side HaloPlan and
  the per-block tables the port keeps) on box_mixed_mesh(5,3,3) at D = 4,
  with and without the hanging nodes of a 1:8 refinement of its TET4
  block;
* every single type other than TET4 and HEX8 (TET10, HEX20, HEX27, TRI3,
  QUAD4, QUAD8, QUAD9; PRISM6 and PYRAMID5 as one-block MixedMeshes, the
  only way the port meshes them) on 3 shards against the port's
  one-device f64 system at rtol 1e-14: 3 steps within 1e-10 relative L2;
* QUAD4 against the reference's own HaloShardedSystem on 3 virtual
  devices (the qp path, rtol 1e-13): 3 steps within 1e-10, the inner
  iterations within 1;
* the mixed halo system on box_mixed_mesh(5,3,3) at D = 4 against
  MixedTransientRDCSystem in f64, with and without the hanging-node
  constraints of the mixed 1:8 AMR: 2 steps within 1e-8;
* shard_elem_field's two mixed forms, and a shard that holds none of a
  block's elements launching nothing for it.

Both packages partition through the same C++ RCB (tests/torch_helpers.
reference_native_rcb, as in tests/test_torch_halo.py)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as DeviceMesh

from rdcfes_tpu.mesh import box_quad_mesh as jbox_quad_mesh
from rdcfes_tpu.models.pihna import pihna_blocks as jpihna_blocks
from rdcfes_tpu.models.pihna import pihna_physics as jpihna_physics
from rdcfes_tpu.parallel.halo import HaloShardedSystem as JHalo
from rdcfes_tpu.parallel.halo import build_mixed_plan as jbuild_mixed_plan

from rdcfes_tpu_torch.mesh import (Mesh, MeshBlock, MixedConstrained,
                                   MixedMesh, box_hex_mesh, box_mixed_mesh,
                                   box_quad_mesh, box_tet_mesh, box_tri_mesh,
                                   tet4_to_tet10)
from rdcfes_tpu_torch.models.pihna import pihna_blocks
from rdcfes_tpu_torch.parallel import HaloShardedSystem
from rdcfes_tpu_torch.parallel.halo import build_mixed_plan
from rdcfes_tpu_torch.systems import (MixedTransientRDCSystem,
                                      TransientRDCSystem)

from tests.elevate import elevate_hex, elevate_quad
from tests.test_torch_halo import pihna_case
from tests.torch_helpers import quick_compile, reference_native_rcb, rel_l2


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    with reference_native_rcb(tmp_path_factory.mktemp("ref_meshkit")):
        yield


def one_block(elem_type, coords, conn):
    """A one-block MixedMesh of conn's nodes only (renumbered)."""
    used, local = np.unique(conn, return_inverse=True)
    return MixedMesh(coords[used], [MeshBlock(elem_type,
                                              local.reshape(conn.shape))])


def type_mesh(kind):
    """A mesh of a few elements of type `kind`."""
    if kind == "TET10":
        return tet4_to_tet10(box_tet_mesh(2, 2, 2))
    if kind in ("HEX20", "HEX27"):
        h = box_hex_mesh(2, 2, 2)
        return Mesh(*elevate_hex(h.coords, h.connectivity, kind == "HEX27"),
                    kind)
    if kind == "TRI3":
        return box_tri_mesh(4, 4)
    if kind in ("QUAD4", "QUAD8", "QUAD9"):
        q = box_quad_mesh(4, 4)
        if kind == "QUAD4":
            return q
        return Mesh(*elevate_quad(q.coords, q.connectivity, kind == "QUAD9"),
                    kind)
    if kind == "PRISM6":
        h = box_hex_mesh(2, 2, 2)
        c = h.connectivity
        return one_block("PRISM6", h.coords, np.concatenate(
            [c[:, [0, 1, 2, 4, 5, 6]], c[:, [0, 2, 3, 4, 6, 7]]]))
    m = box_mixed_mesh(5, 3, 3)
    b = next(b for b in m.blocks if b.elem_type == "PYRAMID5")
    return one_block("PYRAMID5", m.coords, b.connectivity)


def mixed_constrained():
    """box_mixed_mesh(5,3,3) with 10 of its TET4 refined 1:8 against the
    frozen blocks: (mesh, rows [h, a, b])."""
    m = box_mixed_mesh(5, 3, 3)
    flags = np.zeros(m.n_elems, bool)
    off = sum(b.n_elems for b in m.blocks[:2])
    flags[off:off + 10] = True
    r = MixedConstrained.from_mesh(m).refine_and_coarsen(
        flags, np.zeros(m.n_elems, bool), max_level=1)
    assert len(r.constraints)
    return r.mesh, r.constraints


@pytest.mark.parametrize("with_cons", [False, True])
def test_mixed_plan_matches_reference(ref_native, with_cons):
    mesh, cons = (mixed_constrained() if with_cons
                  else (box_mixed_mesh(5, 3, 3), None))
    got, got_b = build_mixed_plan(mesh, 4, constraints=cons)
    want, want_b = jbuild_mixed_plan(mesh, 4, constraints=cons)
    assert got.has_cons == want.has_cons == with_cons
    for name, w in vars(want).items():
        g = getattr(got, name)
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert g.dtype == w.dtype, name
        else:
            assert g == w, name
    assert len(got_b) == len(want_b) == 3
    for g, w in zip(got_b, want_b):
        assert g.keys() <= w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind", ["TET10", "HEX20", "HEX27", "TRI3",
                                  "QUAD4", "QUAD8", "QUAD9", "PRISM6",
                                  "PYRAMID5"])
def test_halo_types_match_single_device(kind):
    mesh = type_mesh(kind)
    p, u0 = pihna_case(mesh)
    one = (MixedTransientRDCSystem if mesh.elem_type == "MIXED"
           else TransientRDCSystem)(mesh, 5, pihna_blocks, rtol=1e-14,
                                    device="cpu")
    h = HaloShardedSystem(mesh, 5, 3, pihna_blocks, rtol=1e-14,
                          device="cpu")
    assert all(len(sh.parts) == 1 for sh in h.shards)
    a, b = h.initial_state(u0), one.initial_state(u0)
    for _ in range(3):
        a, _, res = h.step(a, params=p)
        b, _, _ = one.step(b, params=p)
        assert rel_l2(h.gather(a["u"]), b["u"].numpy()) <= 1e-10
        assert rel_l2(h.gather(a["u_raw"]), b["u_raw"].numpy()) <= 1e-10
        assert float(res) <= 1e-14


def test_quad4_halo_matches_reference(ref_native):
    """The reference's qp-path HaloShardedSystem on 3 virtual devices."""
    jmesh = jbox_quad_mesh(4, 4)
    p, u0 = pihna_case(jmesh)
    sysj = JHalo(jmesh, 5, jpihna_physics,
                 DeviceMesh(np.array(jax.devices()[:3]), ("d",)),
                 physics_blocks=jpihna_blocks, rtol=1e-13)
    mesh = box_quad_mesh(4, 4)
    h = HaloShardedSystem(mesh, 5, 3, pihna_blocks, rtol=1e-13,
                          device="cpu")
    np.testing.assert_array_equal(h.processor_id, sysj.processor_id)
    a, sj = h.initial_state(u0), sysj.initial_state(u0)
    with quick_compile():
        for _ in range(3):
            sj, itj, _ = sysj.step(sj, params=p)
            a, it, res = h.step(a, params=p)
            assert rel_l2(h.gather(a["u"]), sysj.gather(sj["u"])) <= 1e-10
            assert abs(it - int(itj)) <= 1
            assert float(res) <= 1e-13


@pytest.mark.parametrize("hanging", [False, True])
def test_mixed_halo_matches_mixed_system(hanging):
    mesh, cons = (mixed_constrained() if hanging
                  else (box_mixed_mesh(5, 3, 3), None))
    p, u0 = pihna_case(mesh)
    h = HaloShardedSystem(mesh, 5, 4, pihna_blocks, rtol=1e-12,
                          constraints=cons, device="cpu")
    one = MixedTransientRDCSystem(mesh, 5, pihna_blocks, rtol=1e-12,
                                  constraints=cons, device="cpu")
    assert h.plan.has_cons == hanging
    if hanging:
        assert any(sh.cons is not None for sh in h.shards)
    a, b = h.initial_state(u0), one.initial_state(u0)
    for _ in range(2):
        a, _, res = h.step(a, params=p)
        b, _, _ = one.step(b, params=p)
        assert rel_l2(h.gather(a["u"]), b["u"].numpy()) <= 1e-8
        assert rel_l2(h.gather(a["u_raw"]), b["u_raw"].numpy()) <= 1e-8
        assert float(res) <= 1e-12


def test_mixed_shard_fields_and_empty_blocks():
    """Both mixed forms of shard_elem_field follow each block's elements
    onto the shards; a shard that holds none of a block's elements has no
    part for it (it launches nothing there) and an empty tensor in its
    field tuple."""
    mesh = box_mixed_mesh(5, 3, 3)
    h = HaloShardedSystem(mesh, 5, 8, pihna_blocks, device="cpu")
    nb = [b.n_elems for b in mesh.blocks]
    held = [[bi for bi, _, _ in sh.parts] for sh in h.shards]
    assert any(len(x) < 3 for x in held)
    ids = np.arange(mesh.n_elems, dtype=np.float64)
    concat = h.shard_elem_field(np.stack([ids, -ids], axis=1), axis=0)
    starts = np.cumsum([0] + nb)
    per = h.shard_elem_field(tuple(
        np.stack([ids[a:b]] * 2) for a, b in zip(starts[:-1], starts[1:])))
    pid = h.processor_id
    for s, (c, q) in enumerate(zip(concat, per)):
        assert len(c) == len(q) == 3
        for bi in range(3):
            mine = np.nonzero(pid[starts[bi]:starts[bi + 1]] == s)[0]
            got = c[bi][:, 0].numpy()
            assert sorted(got) == sorted(starts[bi] + mine)
            np.testing.assert_array_equal(q[bi][0].numpy(), got)
            assert (len(mine) > 0) == (bi in held[s])
    # the tables of a part: its elements' corners land in the shard slab
    for sh in h.shards:
        for _, blk, g in sh.parts:
            assert blk.conn_T.shape[1] == g.JxW.shape[-1]
            assert int(blk.conn_T.max()) < h.plan.No_max + h.plan.Gtot
