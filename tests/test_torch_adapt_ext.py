"""AMR on TET10 and mixed meshes in the port (mesh/adapt_ext.py,
ConstrainedMesh's frozen edges and pinned nodes, Kelly on TET10, the
constrained MixedTransientRDCSystem and the PIHNA driver's AMR step)
against rdcfes_tpu on the same seeded inputs.

* tet10_skeleton, quadratic_transfer, Tet10Adaptive (refine, then
  coarsen), MixedConstrained (its frozen edges and pinned nodes, 1:8 of
  the TET4 block against the blocks that do not refine, the closure's
  veto on a second all-flagged pass, coarsening), kelly_mixed and Kelly
  on TET10: meshes, constraint rows and transfers equal to the
  reference's, bit for bit; the transfer exact on a quadratic (1e-10, as
  tests/test_adapt_ext.py:60-125); no constraint chained;
* one constrained mixed PIHNA step against the equilibrated dense solve
  of C^T A C on the master dofs, A and b from the reference's
  assemble_scipy (tests/test_adapt_ext.py:175): f64 at rtol 1e-14 within
  1e-10 of each species' largest value, mixed precision at the reference
  test's rtol 1e-12 within its 1e-8; every hanging value the mean of its
  masters;
* the PIHNA driver with one AMR step on make_pihna_case(n=3, mixed=True)
  and on its order=2 case (deck strategy 1to8: the warning, then
  bisection): the checkpoint written after AMR holds the mesh,
  constraints, structure and prolonged state that the reference's AMR
  functions give from the port's first step, and the second step equals
  the port's system rebuilt on that mesh.

The reference's TET10 and mixed step programs are not compiled (minutes
and 23 s); the steps are held to the dense solve and to the port's
systems, whose unconstrained steps tests/test_torch_mixed.py and
tests/test_torch_tet10.py hold to the reference."""

import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sps

import rdcfes_tpu.mesh.adapt_ext as jext
from rdcfes_tpu.fem import amr as jamr
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.mesh import tet4_to_tet10 as jax_tet4_to_tet10
from rdcfes_tpu.models.pihna import pihna_physics
from rdcfes_tpu.systems import MixedTransientRDCSystem as JaxMixed

import rdcfes_tpu_torch.mesh.adapt_ext as ext
from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import pihna as dpihna
from rdcfes_tpu_torch.drivers.common import make_rdc_system
from rdcfes_tpu_torch.fem import amr
from rdcfes_tpu_torch.io.getpot import Deck
from rdcfes_tpu_torch.mesh import adapt_flagged, gmsh
from rdcfes_tpu_torch.models.pihna import pihna_blocks
from rdcfes_tpu_torch.systems import MixedTransientRDCSystem
from rdcfes_tpu_torch.utils.convert import mesh_from_reference

from tests.test_torch_drivers import _keep_each
from tests.test_torch_mixed import _per_species, _pihna_params

B2 = ((0, 2.0),) * 3


def _quad_poly(X):
    """A full quadratic: in the TET10 space, so transfers keep it."""
    x, y, z = X[:, 0], X[:, 1], X[:, 2]
    return (2.0 * x**2 + 3.0 * x * y - z**2 + 0.5 * y * z
            + x - 2.0 * y + 0.25 * z + 1.0)


def _center_flags(coords, conn, frac=0.25):
    cent = coords[conn[:, :4]].mean(axis=1)
    r = np.linalg.norm(cent - coords.mean(axis=0), axis=1)
    return r <= np.quantile(r, frac)


def _tet10(seed=0):
    jm = jax_tet4_to_tet10(jax_box_tet_mesh(3, 3, 3, bounds=B2))
    jm.boundary_id[:] = np.random.default_rng(seed).integers(
        0, 4, len(jm.boundary_id))
    return jm, mesh_from_reference(jm)


def _same_mesh(a, b):
    assert a.elem_type == b.elem_type
    assert np.array_equal(a.coords, b.coords)
    for x, y in zip(getattr(a, "blocks", [a]), getattr(b, "blocks", [b])):
        assert x.elem_type == y.elem_type
        assert np.array_equal(x.connectivity, y.connectivity)
        assert np.array_equal(x.subdomain_id, y.subdomain_id)
    assert np.array_equal(a.boundary_faces, b.boundary_faces)
    assert np.array_equal(a.boundary_id, b.boundary_id)


def _same_outcome(r, jr, n_nodes, n_elems, seed):
    """Mesh, prolongation and elemental transfer equal, bit for bit."""
    assert (r is None) == (jr is None)
    if r is None:
        return
    _same_mesh(r.mesh, jr.mesh)
    rng = np.random.default_rng(seed)
    u, s = rng.random((n_nodes, 3)), rng.random((n_elems, 2))
    assert np.array_equal(r.prolong(u), jr.prolong(u))
    el = getattr(r, "transfer_elemental", None) or r.restrict_elemental
    jel = getattr(jr, "transfer_elemental", None) or jr.restrict_elemental
    assert np.array_equal(el(s), jel(s))
    if hasattr(r, "constraints"):
        assert np.array_equal(r.constraints, jr.constraints)


def test_tet10_skeleton_matches():
    jm, m = _tet10()
    (js, jc), (ps, pc) = jext.tet10_skeleton(jm), ext.tet10_skeleton(m)
    assert np.array_equal(pc, jc)
    _same_mesh(ps, js)
    assert np.array_equal(ps.coords, m.coords[pc])
    assert set(ps.boundary_id) == set(m.boundary_id)


def test_quadratic_transfer_matches_and_is_exact():
    """The transfer onto points inside and on the boundary of the old
    mesh (the refined skeleton's nodes, plus random interior points)
    equals the reference's, and keeps a quadratic to 1e-10."""
    jm, m = _tet10()
    rng = np.random.default_rng(1)
    pts = np.concatenate([
        jax_tet4_to_tet10(jax_box_tet_mesh(4, 5, 3, bounds=B2)).coords,
        2.0 * rng.random((50, 3))])
    t, jt = ext.quadratic_transfer(m, pts), jext.quadratic_transfer(jm, pts)
    u = rng.random((m.n_nodes, 2))
    assert np.array_equal(t(u), jt(u))
    np.testing.assert_allclose(t(_quad_poly(m.coords)), _quad_poly(pts),
                               rtol=0, atol=1e-10)


def test_tet10_adaptive_refine_then_coarsen_matches():
    """Centre flags refine (volume kept, the quadratic kept exactly),
    then coarsening everything collapses what it can; every outcome
    equal to the reference's."""
    jm, m = _tet10()
    ja, pa = jext.Tet10Adaptive.from_mesh(jm), ext.Tet10Adaptive.from_mesh(m)
    flags = _center_flags(m.coords, m.connectivity)
    none = np.zeros(m.n_elems, bool)
    r, jr = (adapt_flagged(pa, flags, none),
             ja.refine_and_coarsen(flags, none))
    _same_outcome(r, jr, m.n_nodes, m.n_elems, 0)
    new = r.mesh
    assert new.elem_type == "TET10" and new.n_elems > m.n_elems
    assert abs(new.element_volumes().sum() - 8.0) < 1e-12
    np.testing.assert_allclose(r.prolong(_quad_poly(m.coords)),
                               _quad_poly(new.coords), rtol=0, atol=1e-10)
    E = new.n_elems
    r2 = adapt_flagged(r.adaptive, np.zeros(E, bool), np.ones(E, bool))
    jr2 = jr.adaptive.refine_and_coarsen(np.zeros(E, bool), np.ones(E, bool))
    _same_outcome(r2, jr2, new.n_nodes, E, 1)
    assert r2.mesh.n_elems < E
    np.testing.assert_allclose(r2.prolong(_quad_poly(new.coords)),
                               _quad_poly(r2.mesh.coords), rtol=0,
                               atol=1e-10)


def _mixed(seed):
    jm = jax_box_mixed_mesh(5, 3, 3, bounds=B2)
    jm.boundary_id[:] = np.random.default_rng(seed).integers(
        0, 5, len(jm.boundary_id))
    return jm, mesh_from_reference(jm)


def _no_chain(cons):
    assert not (set(cons[:, 1]) | set(cons[:, 2])) & set(cons[:, 0])


def _mixed_pass(pc, jc, rf, cf, seed):
    """One refine_and_coarsen of both packages' MixedConstrained: equal
    outcomes, frozen and pinned sets carried equal, no chained
    constraint, the volume kept."""
    r, jr = pc.refine_and_coarsen(rf, cf), jc.refine_and_coarsen(rf, cf)
    _same_outcome(r, jr, pc.mixed.n_nodes, pc.mixed.n_elems, seed)
    if r is not None:
        _no_chain(r.constraints)
        assert abs(r.mesh.element_volumes().sum() - 8.0) < 1e-12
        cm, jcm = r.constrained.cmesh, jr.adaptive.cmesh
        assert set(map(tuple, cm.frozen_edges.tolist())) == set(
            jcm.frozen_edges)
        assert np.array_equal(cm.pinned_nodes, jcm.pinned_nodes)
    return r, jr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_constrained_matches(seed):
    """Frozen edges and pinned nodes from the HEX8 and PYRAMID5 blocks;
    pass 1 refines most tets that touch them (the interface mid nodes
    hang, the other blocks keep their connectivity), pass 2 flags every
    element (the closure vetoes the holders of frozen hanging nodes),
    pass 3 coarsens at random (pinned nodes survive the renumbering);
    each outcome equal to the reference's."""
    jm, m = _mixed(seed)
    jc, pc = (jext.MixedConstrained.from_mesh(jm),
              ext.MixedConstrained.from_mesh(m))
    assert set(map(tuple, pc.cmesh.frozen_edges.tolist())) == set(
        jc.cmesh.frozen_edges)
    assert np.array_equal(pc.cmesh.pinned_nodes, jc.cmesh.pinned_nodes)
    off = sum(b.n_elems for b in m.blocks[:pc.tet_idx])
    tb = m.blocks[pc.tet_idx]
    touches = np.isin(tb.connectivity, pc.cmesh.pinned_nodes).any(axis=1)
    rng = np.random.default_rng(seed)
    rf = np.zeros(m.n_elems, bool)
    rf[off:off + tb.n_elems] = touches & (rng.random(tb.n_elems) < 0.8)
    r, jr = _mixed_pass(pc, jc, rf, np.zeros(m.n_elems, bool), seed)
    assert len(r.constraints)
    for i, b in enumerate(r.mesh.blocks):
        if i != pc.tet_idx:
            assert np.array_equal(b.connectivity, m.blocks[i].connectivity)
    E = r.mesh.n_elems
    r2, jr2 = _mixed_pass(r.constrained, jr.adaptive, np.ones(E, bool),
                          np.zeros(E, bool), seed + 1)
    if r2 is not None:
        r, jr = r2, jr2
    E = r.mesh.n_elems
    r3, _ = _mixed_pass(r.constrained, jr.adaptive, rng.random(E) < 0.1,
                        rng.random(E) < 0.8, seed + 2)
    assert r3 is not None


def test_kelly_mixed_and_tet10_match():
    """kelly_mixed (the TET4 block only, zero elsewhere) and Kelly on
    TET10 (zero for a linear field) equal to the reference's."""
    jm, m = _mixed(0)
    rng = np.random.default_rng(2)
    u = np.stack([_quad_poly(m.coords), rng.random(m.n_nodes)], axis=1)
    eta = ext.kelly_mixed(m, u, [0, 1])
    assert np.array_equal(eta, jext.kelly_mixed(jm, u, [0, 1]))
    off = 0
    for b in m.blocks:
        seg = eta[off:off + b.n_elems]
        assert (seg.max() > 0) if b.elem_type == "TET4" else (seg == 0).all()
        off += b.n_elems
    jm, m = _tet10()
    lin = (m.coords @ np.array([1.0, -2.0, 0.5]))[:, None]
    assert np.abs(amr.kelly_error_indicator(m, lin, [0])).max() < 1e-12
    u = np.stack([_quad_poly(m.coords), rng.random(m.n_nodes)], axis=1)
    eta = amr.kelly_error_indicator(m, u, [0, 1])
    assert np.array_equal(eta, jamr.kelly_error_indicator(jm, u, [0, 1]))
    assert eta.max() > 0


def test_constrained_mixed_step_matches_dense_reduced_solve():
    """One constrained PIHNA step on the refined box_mixed_mesh(4,2,2)
    against the dense solve of C^T A C (identity on the hanging rows),
    A and b the reference's assemble_scipy."""
    jm = jax_box_mixed_mesh(4, 2, 2, bounds=((0, 30.0),) * 3)
    flags = _center_flags(jm.coords, np.concatenate(
        [b.connectivity[:, :4] for b in jm.blocks]), frac=0.3)
    jr = jext.MixedConstrained.from_mesh(jm).refine_and_coarsen(
        flags, np.zeros(jm.n_elems, bool))
    r = ext.MixedConstrained.from_mesh(mesh_from_reference(jm)
                                       ).refine_and_coarsen(
        flags, np.zeros(jm.n_elems, bool))
    _same_outcome(r, jr, jm.n_nodes, jm.n_elems, 0)
    cons = r.constraints
    assert len(cons)
    p = _pihna_params()
    V, N = 5, r.mesh.n_nodes
    rng = np.random.default_rng(0)
    u0 = np.abs(rng.random((N, V))) * np.array([1., 100., 50., 500., 1e-10])
    u0[cons[:, 0]] = 0.5 * (u0[cons[:, 1]] + u0[cons[:, 2]])

    A, rhs = JaxMixed(jr.mesh, V, pihna_physics).assemble_scipy(u0.T, {}, p)
    Cn = sps.lil_matrix((N, N))
    master = np.ones(N, bool)
    master[cons[:, 0]] = False
    for i in np.nonzero(master)[0]:
        Cn[i, i] = 1.0
    for h, a, b in cons:
        Cn[h, a] = Cn[h, b] = 0.5
    C = sps.block_diag([Cn.tocsr()] * V, format="csr")
    Ac = (C.T @ A @ C).tolil()
    bc = C.T @ rhs
    for v in range(V):
        for h in cons[:, 0]:
            Ac[v * N + h, v * N + h] = 1.0
            bc[v * N + h] = 0.0
    svar = np.abs(u0).max(axis=0) + 1e-30
    Scol = np.concatenate([np.full(N, s) for s in svar])
    Ad = Ac.toarray() * Scol[None, :]
    rrow = 1.0 / (np.abs(Ad).max(axis=1) + 1e-300)
    y = np.linalg.solve(Ad * rrow[:, None], bc * rrow)
    u_ref = (C @ (y * Scol)).reshape(V, N).T

    for precision, rtol, bar in (("f64", 1e-14, 1e-10),
                                 ("mixed", 1e-12, 1e-8)):
        s = MixedTransientRDCSystem(r.mesh, V, pihna_blocks,
                                    precision=precision, rtol=rtol,
                                    constraints=cons, device="cpu")
        st, _, res = s.step(s.initial_state(u0), params=p)
        assert float(res) <= rtol
        u = st["u_raw"].numpy()
        assert _per_species(u, u_ref) <= bar, precision
        for key in ("u", "u_raw"):
            x = st[key].numpy()
            assert np.array_equal(x[cons[:, 0]],
                                  0.5 * (x[cons[:, 1]] + x[cons[:, 2]]))


@pytest.mark.parametrize("kind", ["mixed", "tet10"])
def test_pihna_driver_amr(kind, tmp_path, monkeypatch, capsys):
    """Two steps with an AMR step after the first (TET10 asks for 1to8:
    the warning, then skeleton bisection); the step-1 checkpoint, written
    after AMR, equal to the reference's Kelly, flags, adaptation and
    transfers applied to the port's first step, and the step-2 state to
    the port's system rebuilt on the adapted mesh."""
    kw = {"mixed": True} if kind == "mixed" else {"order": 2}
    d = cases.make_pihna_case(str(tmp_path / kind), n=3, n_steps=2, **kw)
    path = os.path.join(d, "input.dat")
    deck_text = open(path).read().replace(
        "refinement_step = 10000", "refinement_step = 1")
    deck_text += "checkpoint/step = 1\n"
    if kind == "tet10":
        deck_text += "mesh/AMR/strategy = 1to8\n"
    with open(path, "w") as f:
        f.write(deck_text)
    monkeypatch.chdir(d)
    monkeypatch.setattr(dpihna, "save_checkpoint",
                        _keep_each(dpihna.save_checkpoint))
    out = dpihna.run("input.dat", device="cpu")
    res = capsys.readouterr()
    assert res.out.count(" ==== Step") == 2
    if kind == "tet10":
        assert "WARNING: mesh/AMR/strategy = 1to8 is not honored on TET10" \
            in res.err

    # the reference's AMR step on the port's first step
    deck = Deck("input.dat")
    params = dpihna.load_params(deck)
    mesh = gmsh.read("Brain_Model.msh")
    jm = jgmsh.read("Brain_Model.msh")
    u0 = np.loadtxt("Brain_Model_Initial_Nodal_Field.dat")
    structure = np.loadtxt("Brain_Model_Initial_Elemental_Field.dat")
    s = make_rdc_system(mesh, 5, pihna_blocks, deck, device="cpu")
    st = s.gather_state(s.step(s.initial_state(u0), params=params)[0])
    if kind == "mixed":
        eta = jext.kelly_mixed(jm, st["u"], list(range(5)))
        adaptive = jext.MixedConstrained.from_mesh(jm)
    else:
        eta = jamr.kelly_error_indicator(jm, st["u"], list(range(5)))
        adaptive = jext.Tet10Adaptive.from_mesh(jm)
    flags, coarsen = jamr.flag_by_mean_stddev(
        np.asarray(eta), deck("mesh/AMR/refine_percentage", 0.5),
        deck("mesh/AMR/coarsen_percentage", 0.5))
    jr = adaptive.refine_and_coarsen(flags, coarsen, max_level=3)
    assert jr is not None and jr.mesh.n_elems > jm.n_elems
    cons = jr.constraints if kind == "mixed" else np.zeros((0, 3))
    elem = (jr.transfer_elemental if kind == "mixed"
            else jr.restrict_elemental)(structure)

    ck = np.load(os.path.join(out, "checkpoint-1.npz"))
    for key in ("u", "u_old", "u_older", "u_raw"):
        assert np.array_equal(ck[key], jr.prolong(st[key])), key
    assert np.array_equal(ck["structure"], elem)
    assert np.array_equal(ck.get("constraints", np.zeros((0, 3))), cons)
    refined = gmsh.read(os.path.join(out, "checkpoint_mesh.msh"))
    _same_mesh(refined, jr.mesh)
    tag = f"AMR step 1: adapted to {jr.mesh.n_elems} elements"
    assert tag + (f" ({len(cons)} hanging nodes)" if kind == "mixed"
                  else "") in res.out
    if kind == "mixed":
        assert len(cons)

    sys_kw = {"constraints": cons} if len(cons) else {}
    s2 = make_rdc_system(refined, 5, pihna_blocks, deck, device="cpu",
                         **sys_kw)
    st2, _, r2 = s2.step(s2.scatter_state({k: ck[k] for k in (
        "u", "u_old", "u_older", "u_raw")}), params=params)
    assert float(r2) <= 3e-11
    ck2 = np.load(os.path.join(out, "checkpoint-2.npz"))
    assert np.array_equal(ck2["u"], st2["u"].numpy())
    if kind == "mixed":
        u = ck2["u"]
        assert np.array_equal(u[cons[:, 0]],
                              0.5 * (u[cons[:, 1]] + u[cons[:, 2]]))
    assert (ck2["u"] >= 0).all() and np.isfinite(ck2["u"]).all()
    shutil.rmtree(out)
