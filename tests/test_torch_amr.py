"""The port's AMR against rdcfes_tpu's: the Kelly indicator and the
mean-stddev flags, uniform and flagged refinement, bisection with
coarsening (mesh/adapt.py), selective 1:8 with hanging-node constraints
(mesh/constrain.py), and the constrained transient step
(`TransientRDCSystem(constraints=)`), on seeded inputs through both
packages:

* Kelly's eta within 1e-13 relative, the flags equal;
* connectivity, coordinates, boundary ids, forests and constraint rows
  equal; the prolonged and transferred fields within 1e-15;
* one constrained f64 step, solved at rtol 1e-14 by both, within 1e-10
  relative (one species, so the reference's program compiles fast), and
  the port's run_steps equal to its steps with the constraints holding.

The PIHNA driver with AMR is held to the reference's in
tests/test_torch_drivers.py."""

import numpy as np
import pytest
import torch

import rdcfes_tpu.fem.weakform as jwf
import rdcfes_tpu.mesh as jmesh
from rdcfes_tpu.fem import amr as jamr
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

import rdcfes_tpu_torch.mesh as pmesh
from rdcfes_tpu_torch.fem import amr
from rdcfes_tpu_torch.fem.weakform import WeakFormBlocks
from rdcfes_tpu_torch.systems import TransientRDCSystem

from tests.torch_helpers import quick_compile

V = 5


def _field(mesh, seed):
    """Seeded nodal fields (N, V): a localised bump per species over
    noise, so the flux jumps differ from element to element."""
    rng = np.random.default_rng(seed)
    c = mesh.coords
    mid = c.mean(axis=0)
    L2 = (np.ptp(c, axis=0) ** 2).sum()
    r2 = ((c - mid) ** 2).sum(axis=1)
    u = 0.1 * rng.random((mesh.n_nodes, V))
    u += np.exp(-r2 / (0.05 * L2))[:, None] * np.arange(1, V + 1)
    return u


def _meshes(kind):
    if kind == "tet":
        return jmesh.box_tet_mesh(4, 4, 4), pmesh.box_tet_mesh(4, 4, 4)
    return jmesh.box_hex_mesh(3, 3, 3), pmesh.box_hex_mesh(3, 3, 3)


def _same_mesh(a, b):
    assert a.elem_type == b.elem_type
    for name in ("coords", "connectivity", "subdomain_id", "boundary_faces",
                 "boundary_elem", "boundary_side", "boundary_id"):
        x, y = getattr(a, name), getattr(b, name)
        assert np.array_equal(x, y), name


def _close(a, b, tol=1e-15):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_kelly_and_flags_match(kind):
    jm, pm = _meshes(kind)
    u = _field(pm, 3)
    ref = jamr.kelly_error_indicator(jm, u, list(range(V)))
    eta = amr.kelly_error_indicator(pm, u, list(range(V)))
    assert eta.shape == (pm.n_elems,)
    assert np.abs(eta - ref).max() <= 1e-13 * np.abs(ref).max()
    for fr, fc in ((0.5, 0.5), (0.2, 1.0)):
        rf, cf = amr.flag_by_mean_stddev(eta, fr, fc)
        jrf, jcf = jamr.flag_by_mean_stddev(ref, fr, fc)
        assert np.array_equal(rf, jrf) and np.array_equal(cf, jcf)
        assert rf.any() and cf.any()


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_refine_flagged_matches(kind):
    jm, pm = _meshes(kind)
    u = _field(pm, 4)
    flags, _ = amr.flag_by_mean_stddev(
        amr.kelly_error_indicator(pm, u, range(V)), 0.5, 0.5)
    r = pmesh.refine_flagged(pm, flags)
    jr = jmesh.refine_flagged(jm, flags)
    _same_mesh(r.mesh, jr.mesh)
    assert r.mesh.n_elems == 8 * pm.n_elems
    _close(r.prolong(u), jr.prolong(u))
    s = np.random.default_rng(5).random((pm.n_elems, 2))
    _close(r.restrict_elemental(s), jr.restrict_elemental(s))
    # nothing flagged leaves the mesh alone
    assert pmesh.refine_flagged(pm, np.zeros(pm.n_elems, bool)) is None


def _adapt_case():
    jm, pm = jmesh.box_tet_mesh(3, 3, 3), pmesh.box_tet_mesh(3, 3, 3)
    u = _field(pm, 6)
    return jm, pm, u


def _same_adaptive(a, b):
    _same_mesh(a.mesh, b.mesh)
    for name in ("level", "sibling", "midpoint"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("max_level", [1, 3])
def test_adapt_flagged_refine_and_coarsen_match(max_level):
    """Bisection: a refine pass from Kelly's flags, then a
    refine-and-coarsen pass whose coarsen flags merge sibling pairs back,
    each against the reference's; max_level caps the depth."""
    jm, pm, u = _adapt_case()
    ja, pa = jmesh.AdaptiveMesh(jm), pmesh.AdaptiveMesh(pm)
    s = np.random.default_rng(7).random((pm.n_elems, 2))
    for cycle in range(2):
        eta = amr.kelly_error_indicator(pa.mesh, u, range(V))
        rf, cf = amr.flag_by_mean_stddev(eta, 0.5, 0.5)
        if cycle == 1:  # coarsen what was just refined, refine elsewhere
            cf = pa.level > 0
            rf = rf & (pa.level == 0)
            assert pa.coarsen(cf) is not None
        r = pmesh.adapt_flagged(pa, rf, cf, max_level=max_level)
        jr = jmesh.adapt_flagged(ja, rf, cf, max_level=max_level)
        _same_adaptive(r.adaptive, jr.adaptive)
        _close(r.prolong(u), jr.prolong(u))
        _close(r.restrict_elemental(s), jr.restrict_elemental(s))
        pa, ja = r.adaptive, jr.adaptive
        u, s = r.prolong(u), r.restrict_elemental(s)
    assert pa.level.max() <= 3 * max_level + 1


def _same_constrained(a, b):
    _same_mesh(a.mesh, b.mesh)
    assert np.array_equal(a.constraints, b.constraints)
    assert np.array_equal(a.elem_group, b.elem_group)
    assert np.array_equal(a.elem_level, b.elem_level)
    assert sorted(a.groups) == sorted(b.groups)


def test_constrained_refine_and_coarsen_match():
    """1:8 with hanging nodes: a refine pass, then refine-and-coarsen
    collapsing groups and refining elsewhere, against the reference's."""
    jm, pm, u = _adapt_case()
    jc, pc = jmesh.ConstrainedMesh(jm), pmesh.ConstrainedMesh(pm)
    rf, _ = amr.flag_by_mean_stddev(
        amr.kelly_error_indicator(pm, u, range(V)), 0.5, 0.5)
    r, jr = pc.refine(rf), jc.refine(rf)
    _same_constrained(r.constrained, jr.constrained)
    assert len(r.constrained.constraints)
    _close(r.prolong(u), jr.prolong(u))
    assert np.array_equal(r.elem_map, jr.elem_map)
    pc, jc, u = r.constrained, jr.constrained, r.prolong(u)
    s = np.random.default_rng(8).random((pc.mesh.n_elems, 2))
    cf = pc.elem_level > 0
    rf = np.zeros(pc.mesh.n_elems, bool)
    rf[np.nonzero(pc.elem_level == 0)[0][::7]] = True
    r = pc.refine_and_coarsen(rf, cf, max_level=2)
    jr = jc.refine_and_coarsen(rf, cf, max_level=2)
    _same_constrained(r.constrained, jr.constrained)
    assert r.kept_nodes is not None  # the pass did coarsen
    assert np.array_equal(r.kept_nodes, jr.kept_nodes)
    _close(r.prolong(u), jr.prolong(u))
    _close(r.transfer_elemental(s), jr.transfer_elemental(s))


# ----------------------------------------------------------------------
# the constrained step
# ----------------------------------------------------------------------
def _blocks(u_qp, grad_qp, params, blocks_cls):
    """One species: u_t = div(k grad u) - r u^2 (linearised CN), the same
    expression for jax.numpy and torch."""
    dt, k, r = params["dt"], params["k"], params["r"]
    u, g = u_qp[0], grad_qp[0]
    mass = 1.0 + 0.5 * dt * r * u
    return blocks_cls(A=(u - 0.5 * dt * r * u * u,),
                      B=(-0.5 * dt * k * g,), C=((mass,),), D=((0.0,),),
                      E=((0.5 * dt * k + 0.0 * u,),))


def _jax_blocks(u_qp, grad_qp, fields, params):
    return _blocks(u_qp, grad_qp, params, jwf.WeakFormBlocks)


def _torch_blocks(u_qp, grad_qp, fields, params):
    return _blocks(u_qp, grad_qp, params, WeakFormBlocks)


PARAMS = {"dt": 0.05, "k": 0.3, "r": 0.4}


@pytest.fixture(scope="module")
def constrained_case():
    jm = jmesh.box_tet_mesh(3, 3, 3)
    pm = pmesh.box_tet_mesh(3, 3, 3)
    cent = pm.coords[pm.connectivity].mean(axis=1)
    r = np.linalg.norm(cent - pm.coords.mean(axis=0), axis=1)
    flags = r <= np.quantile(r, 0.2)
    res = pmesh.ConstrainedMesh(pm).refine(flags)
    jres = jmesh.ConstrainedMesh(jm).refine(flags)
    cons = res.constrained.constraints
    assert np.array_equal(cons, jres.constrained.constraints) and len(cons)
    rng = np.random.default_rng(9)
    u0 = 1.0 + rng.random((res.constrained.mesh.n_nodes, 1))
    u0[cons[:, 0]] = 0.5 * (u0[cons[:, 1]] + u0[cons[:, 2]])
    with quick_compile():
        jsys = JaxSystem(jres.constrained.mesh, 1, None,
                         physics_blocks=_jax_blocks, precision="f64",
                         fast_gather="off", rtol=1e-14, constraints=cons)
        st, _, res_ = jsys.step(jsys.initial_state(u0), params=PARAMS)
    assert float(res_) <= 1e-14
    return res.constrained.mesh, cons, u0, jsys.gather_state(st)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_constrained_step_matches_reference(constrained_case, precision):
    mesh, cons, u0, ref = constrained_case
    sys_ = TransientRDCSystem(mesh, 1, _torch_blocks, rtol=1e-14,
                              precision=precision, constraints=cons,
                              device="cpu")
    st, _, res = sys_.step(sys_.initial_state(u0), params=PARAMS)
    assert float(res) <= 1e-14
    for key in ("u", "u_raw"):
        out = st[key].numpy()
        assert np.abs(out - ref[key]).max() <= 1e-10 * np.abs(ref[key]).max()
        h, a, b = cons.T
        assert np.array_equal(out[h], 0.5 * (out[a] + out[b]))


def test_constrained_run_steps_matches_steps(constrained_case):
    """run_steps == step by step (the block-Jacobi reuse schedule too),
    and u_h = (u_a + u_b) / 2 holds in every state."""
    mesh, cons, u0, _ = constrained_case
    kw = dict(rtol=1e-12, precision="mixed", precond_refresh=2,
              constraints=cons, device="cpu")
    a = TransientRDCSystem(mesh, 1, _torch_blocks, **kw)
    sa, its_a, _ = a.run_steps(a.initial_state(u0), 3, params=PARAMS)
    b = TransientRDCSystem(mesh, 1, _torch_blocks, **kw)
    sb = b.initial_state(u0)
    its_b = []
    for _ in range(3):
        sb, it, _ = b.step(sb, params=PARAMS)
        its_b.append(it)
    assert its_a.tolist() == its_b
    assert torch.equal(sa["u"], sb["u"])
    h, ia, ib = (torch.as_tensor(c) for c in cons.T)
    u = sa["u"]
    assert torch.equal(u[h], 0.5 * (u[ia] + u[ib]))
