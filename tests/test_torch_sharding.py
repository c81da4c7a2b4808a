"""The port's replicated-iterate multi-device system
(rdcfes_tpu_torch/parallel/sharding.py) against
rdcfes_tpu/parallel/sharding.py on the CPU (`device="cpu"`: every shard on
the CPU; conftest gives the reference 8 virtual devices):

* partition_elements equals the reference's;
* the padded conn_T, JxW and dphi and the per-shard node_gather tables
  equal the reference's ShardedTransientSystem arrays exactly;
* one PIHNA step at D = 8 on box_tet_mesh(3,3,3) against the reference's
  sharded step on 8 virtual devices and against a dense direct solve of
  the same step (tests/test_sharding.py's bar: 3e-8 of each species'
  scale in max norm, both residuals < 1e-10); the direct solve is the
  port's assembled operator (held to the reference's at 1e-13 in
  tests/test_torch_dense.py) through LAPACK, which costs no reference
  compile;
* three steps within 1e-4 of the port's single-device dense system in
  f64 (the bar of tests/test_sharding.py's trajectory test: the PIHNA
  operator's conditioning, ~1e21, lets summation orders drift apart);
* one HEX8, one QUAD4 and one TRI3 step at D = 3 against the reference's
  sharded step on 3 virtual devices (which takes 2D meshes too) and
  against the dense direct solve, at the same 3e-8 bar (PIHNA; on HEX8
  also a one-species physics, which the reference compiles in seconds
  where its PIHNA step takes ~40 s);
* a MixedMesh raises ValueError, no placement needs the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

from rdcfes_tpu.fem.weakform import WeakForm as JWeakForm
from rdcfes_tpu.mesh import box_hex_mesh as jbox_hex_mesh
from rdcfes_tpu.mesh import box_quad_mesh as jbox_quad_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jbox_tet_mesh
from rdcfes_tpu.mesh import box_tri_mesh as jbox_tri_mesh
from rdcfes_tpu.models.pihna import pihna_physics as jpihna_physics
from rdcfes_tpu.parallel import ShardedTransientSystem as JSharded
from rdcfes_tpu.parallel import partition_elements as jpartition

from rdcfes_tpu_torch.fem.weakform import WeakForm as TWeakForm
from rdcfes_tpu_torch.mesh import (box_hex_mesh, box_mixed_mesh,
                                   box_quad_mesh, box_tet_mesh, box_tri_mesh)
from rdcfes_tpu_torch.models.pihna import default_params, pihna_physics
from rdcfes_tpu_torch.parallel import (ShardedTransientSystem,
                                       partition_elements)
from rdcfes_tpu_torch.systems import TransientRDCSystem

from tests.torch_helpers import assembled_solve, quick_compile


def _deck():
    """The shipped PIHNA deck (tests/test_pihna.py run_deck_params), as
    plain floats."""
    Kk = 2.39e5
    p = default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1.0e-8,
             necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk,
             necrosis_v=300.0 / Kk, produce_c=-2.5, switch_c2h=1.0,
             switch_h2c=1.82, switch_h2n=0.5, diffuse_v=0.5, produce_v=10.0,
             secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, decay_a=5678.4)
    return {k: float(v) for k, v in p.items()}


def _state(n_nodes, params):
    """tests/test_sharding.py's seeded state."""
    rng = np.random.default_rng(123)
    Kk = params["cells_max_capacity"]
    u0 = np.zeros((n_nodes, 5))
    u0[:, 1] = 0.1 * Kk * rng.random(n_nodes)
    u0[:, 3] = 0.03 * Kk
    u0[:, 4] = 1e-9
    return u0


def _decay(u_qp, grad_qp, fields, params, W=TWeakForm, ones=torch.ones_like):
    """One species, u_t = d lap u - k u, linearized Crank-Nicolson: a
    one-variable dense WeakForm whose reference step compiles in seconds
    on HEX8 (the five-species PIHNA step compiles for ~40 s there)."""
    h, d, k = params["dt"] / 2.0, params["diffuse"], params["decay"]
    one = ones(u_qp)
    return W(A=(1.0 - h * k) * u_qp, B=-h * d * grad_qp,
             C=((1.0 + h * k) * one)[None], E=(h * d * one)[None])


def _jdecay(u_qp, grad_qp, fields, params):
    return _decay(u_qp, grad_qp, fields, params, W=JWeakForm,
                  ones=jnp.ones_like)


_DECAY = dict(dt=0.1, diffuse=0.5, decay=2.0)


def _direct(mesh, params, u0, physics=pihna_physics):
    """The dense direct solve of one step, clamped (tests/test_sharding.py's
    ground truth): the port's single-device `assemble` (the operator and
    right-hand side of the reference's, within 1e-13:
    tests/test_torch_dense.py) solved by LAPACK."""
    s = TransientRDCSystem(mesh, u0.shape[1], physics=physics,
                           device="cpu")
    values, b = s.assemble(u0.T, {}, params)
    x = assembled_solve(values.numpy(), b.numpy(), s.sp.rows, s.sp.cols,
                        mesh.n_nodes)
    return np.maximum(x, 0.0)


def _within(u, ref, bar, what):
    for v in range(ref.shape[1]):
        scale = np.abs(ref[:, v]).max()
        err = np.abs(u[:, v] - ref[:, v]).max()
        assert err <= bar * scale, f"{what}, var {v}: {err / scale:.2e}"


@pytest.fixture(scope="module")
def tet_case():
    """The TET4 case, the reference's sharded step at D = 8 on the
    virtual devices and the direct solve."""
    params = _deck()
    jmesh = jbox_tet_mesh(3, 3, 3)
    u0 = _state(jmesh.n_nodes, params)
    devices = np.array(jax.devices()[:8])
    assert devices.size == 8, "conftest must provide 8 virtual devices"
    with quick_compile():
        jsys = JSharded(jmesh, 5, jpihna_physics, DeviceMesh(devices, ("d",)))
        u1, _, res = jsys.step(jsys.initial_state(u0), params=params)
    return dict(params=params, u0=u0, ref=np.asarray(u1), ref_res=float(res),
                direct=_direct(box_tet_mesh(3, 3, 3), params, u0))


@pytest.mark.parametrize("E,D", [(1, 1), (162, 8), (162, 3), (7, 8),
                                 (131712, 4), (110592, 3)])
def test_partition_elements_matches_reference(E, D):
    assert partition_elements(E, D) == jpartition(E, D)


@pytest.mark.parametrize("D", [2, 3, 8])
def test_tables_match_reference(D):
    jmesh = jbox_tet_mesh(3, 3, 3)
    want = JSharded(jmesh, 5, jpihna_physics,
                    DeviceMesh(np.array(jax.devices()[:D]), ("d",)))
    got = ShardedTransientSystem(box_tet_mesh(3, 3, 3), 5, pihna_physics, D,
                                 device="cpu")
    assert got.Eb == want.Eb and got.n_shards == D
    assert np.array_equal(got.phi, np.asarray(want.phi))
    for name in ("conn_T", "JxW", "dphi", "node_gather"):
        g, w = getattr(got, name), np.asarray(getattr(want, name + "_s"))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # each shard's device tables are its slices of the host tables
    Eb = got.Eb
    for s, sh in enumerate(got.shards):
        sl = slice(s * Eb, (s + 1) * Eb)
        np.testing.assert_array_equal(sh.blk.conn_T.numpy(),
                                      got.conn_T[:, sl])
        np.testing.assert_array_equal(sh.geom.JxW.numpy(), got.JxW[:, sl])
        np.testing.assert_array_equal(sh.geom.dphi.numpy(),
                                      got.dphi[0, ..., sl])
        np.testing.assert_array_equal(sh.node_gather.numpy(),
                                      got.node_gather[s])


def test_pihna_step_d8_matches_reference_and_direct(tet_case):
    c = tet_case
    s = ShardedTransientSystem(box_tet_mesh(3, 3, 3), 5, pihna_physics, 8,
                               device="cpu")
    u1, iters, res = s.step(s.initial_state(c["u0"]), params=c["params"])
    u1 = u1.numpy()
    assert u1.shape == (64, 5) and iters > 0
    assert float(res) < 1e-10 and c["ref_res"] < 1e-10
    _within(u1, c["direct"], 3e-8, "port vs direct")
    _within(c["ref"], c["direct"], 3e-8, "reference vs direct")
    _within(u1, c["ref"], 3e-8, "port vs reference")


def test_three_steps_track_single_device(tet_case):
    c = tet_case
    mesh = box_tet_mesh(3, 3, 3)
    one = TransientRDCSystem(mesh, 5, physics=pihna_physics,
                             precision="f64", device="cpu")
    st = one.initial_state(c["u0"])
    s = ShardedTransientSystem(mesh, 5, pihna_physics, 8, device="cpu")
    u = s.initial_state(c["u0"])
    for _ in range(3):
        st, _, _ = one.step(st, params=c["params"])
        u, _, res = s.step(u, params=c["params"])
        assert float(res) < 1e-10
    _within(u.numpy(), st["u"].numpy(), 1e-4, "3 steps vs one device")


def _sharded_steps(shape, make, jmake, physics, jphysics, params, u0):
    """One step at D = 3 by the port (CPU shards) and by the reference
    (3 virtual devices): (port u1, reference u1), both residuals checked."""
    mesh = make(*shape)
    s = ShardedTransientSystem(mesh, u0.shape[1], physics, 3, device="cpu")
    assert s.Eb * 3 >= mesh.n_elems > s.Eb * 2
    u1, _, res = s.step(s.initial_state(u0), params=params)
    with quick_compile():
        jsys = JSharded(jmake(*shape), u0.shape[1], jphysics,
                        DeviceMesh(np.array(jax.devices()[:3]), ("d",)))
        ref, _, ref_res = jsys.step(jsys.initial_state(u0), params=params)
    assert float(res) < 1e-10 and float(ref_res) < 1e-10
    return u1.numpy(), np.asarray(ref)


@pytest.mark.parametrize("kind", ["hex8", "quad4", "tri3"])
def test_step_matches_reference_and_direct(kind):
    """HEX8 (K8), QUAD4 and TRI3 (2D meshes, which the reference's system
    also takes: its 2D dphi has the zero third component it pads to) at
    D = 3: the port's PIHNA step against the dense direct solve, and the
    port's step against the reference's sharded step on 3 virtual devices
    and both against the direct solve: PIHNA on the 2D meshes, the
    one-species _decay physics on HEX8 (its PIHNA compile alone would
    take ~40 s)."""
    params = _deck()
    shape, make, jmake = {
        "hex8": ((2, 2, 2), box_hex_mesh, jbox_hex_mesh),
        "quad4": ((3, 3), box_quad_mesh, jbox_quad_mesh),
        "tri3": ((3, 3), box_tri_mesh, jbox_tri_mesh)}[kind]
    mesh = make(*shape)
    u0 = _state(mesh.n_nodes, params)
    direct = _direct(mesh, params, u0)
    if kind == "hex8":
        s = ShardedTransientSystem(mesh, 5, pihna_physics, 3, device="cpu")
        u1, _, res = s.step(s.initial_state(u0), params=params)
        assert float(res) < 1e-10
        _within(u1.numpy(), direct, 3e-8, f"{kind}: PIHNA port vs direct")
        params = _DECAY
        u0 = np.random.default_rng(7).random((mesh.n_nodes, 1))
        direct = _direct(mesh, params, u0, physics=_decay)
        pair = (_decay, _jdecay)
    else:
        pair = (pihna_physics, jpihna_physics)
    u1, ref = _sharded_steps(shape, make, jmake, *pair, params, u0)
    _within(u1, direct, 3e-8, f"{kind}: port vs direct")
    _within(ref, direct, 3e-8, f"{kind}: reference vs direct")
    _within(u1, ref, 3e-8, f"{kind}: port vs reference")


def test_mixed_mesh_raises_and_card_by_default():
    with pytest.raises(ValueError, match="one connectivity"):
        ShardedTransientSystem(box_mixed_mesh(3, 2, 2), 5, pihna_physics, 2,
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedTransientSystem(box_tet_mesh(2, 2, 2), 5, pihna_physics,
                                   2)
