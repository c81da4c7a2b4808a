"""The dense element-matrix path of rdcfes_tpu_torch (a `physics=`
WeakForm: element_vectors, element_matrices, the dense step, `assemble`,
the five `*_physics` forms, the qp / dense dispatch) held to rdcfes_tpu on the same seeded NumPy inputs,
and inverse-distance interpolation.

MixedTransientRDCSystem.assemble_scipy is held in
tests/test_torch_mixed.py, beside the reference's own call there.

Tolerances: the weak-form pieces, `assemble` and the `*_physics` forms within 1e-13 of the largest reference value (the port
contracts with einsum where the reference unrolls, f64 reassociation
only); a dense step within 1e-10 relative L2 of the reference's assembled
operator solved directly and of the port's own qp step, at rtol 1e-14
(the Krylov tolerance times the conditioning); the interpolation within
1e-13, exact on a node.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.mesh import box_quad_mesh as jax_box_quad_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.models import adpm as jadpm
from rdcfes_tpu.models import hcc as jhcc
from rdcfes_tpu.models import pihna as jpihna
from rdcfes_tpu.models import proteas as jproteas
from rdcfes_tpu.models import ripf as jripf
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem
from rdcfes_tpu.utils import inverse_distance_interpolate as jax_ida

from rdcfes_tpu_torch.fem import geometry, weakform
from rdcfes_tpu_torch.fem.kernels import PLAIN_OPS
from rdcfes_tpu_torch.models import adpm, hcc, pihna, proteas, ripf
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.utils import inverse_distance_interpolate
from rdcfes_tpu_torch.utils.convert import (blocks_from_numpy,
                                            mesh_from_reference,
                                            weakform_from_numpy)
from tests.test_torch_mesh2d import pihna_case, rel
from tests.torch_helpers import (quick_compile, reference_assembled_step,
                                 rel_l2)

TOL = 1e-13


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """The reference's eager calls compile each primitive they meet; at
    these sizes that compile is their whole cost, so skip XLA's
    optimisation passes (tests/torch_helpers.quick_compile)."""
    with quick_compile():
        yield


def _wf_case(elem_type, seed=5, V=3):
    """A seeded dense WeakForm on a jittered TET4 or QUAD4 box, with its
    geometry in both packages."""
    jm = (jax_box_tet_mesh(2, 1, 1) if elem_type == "TET4"
          else jax_box_quad_mesh(2, 2))
    rng = np.random.default_rng(seed)
    x = jm.coords + 0.02 * rng.standard_normal(jm.coords.shape) * (
        [1, 1, 1] if elem_type == "TET4" else [1, 1, 0])
    phi, JxW, dphi = geometry.geometry_factors(
        torch.as_tensor(x), torch.as_tensor(jm.connectivity), elem_type)
    Q, E = JxW.shape
    wf = jwf.WeakForm(A=rng.standard_normal((V, Q, E)),
                      B=rng.standard_normal((V, Q, 3, E)),
                      C=rng.standard_normal((V, V, Q, E)),
                      D=rng.standard_normal((V, V, Q, 3, E)),
                      E=rng.standard_normal((V, V, Q, E)))
    return wf, phi, JxW, dphi


@pytest.mark.parametrize("elem_type,absent", [("TET4", ("B", "D")),
                                              ("QUAD4", ())])
def test_element_vectors_and_matrices_match(elem_type, absent):
    """element_vectors, and element_matrices with its diagonal, on the
    affine route (TET4, grad_const; its taxis term is held through
    `assemble` below) without the flux and taxis fields, and on the per-q
    route (QUAD4) with all five."""
    wf, phi, JxW, dphi = _wf_case(elem_type)
    wf = wf._replace(**{k: None for k in absent})
    jw = jwf.WeakForm(*(None if a is None else jnp.asarray(a) for a in wf))
    tw = weakform_from_numpy(wf, "cpu")
    grad_const = elem_type == "TET4"
    jargs = (phi, jnp.asarray(JxW.numpy()), jnp.asarray(dphi.numpy()))
    ref_Fe = jwf.element_vectors(jw, *jargs)
    ref_Ke, ref_d = jwf.element_matrices(jw, *jargs, grad_const=grad_const,
                                         return_diag=True)
    Fe = weakform.element_vectors(tw, phi, JxW, dphi)
    Ke, d = weakform.element_matrices(tw, phi, JxW, dphi,
                                      grad_const=grad_const,
                                      return_diag=True)
    assert rel(Fe, ref_Fe) < TOL
    assert rel(Ke, ref_Ke) < TOL and rel(d, ref_d) < TOL
    assert torch.equal(weakform.element_matrices(tw, phi, JxW, dphi,
                                                 grad_const=grad_const), Ke)


def test_to_dense_matches():
    rng = np.random.default_rng(7)
    V, Q, E = 3, 4, 6
    live = lambda shape, on: rng.standard_normal(shape) if on else 0.0
    args = ([live((Q, E), v != 1) for v in range(V)],
            [live((Q, 3, E), v == 2) for v in range(V)],
            [[live((Q, E), (v + w) % 2 == 0) for w in range(V)]
             for v in range(V)],
            [[live((Q, 3, E), v == w) for w in range(V)] for v in range(V)],
            [[live((Q, E), v == 0) for w in range(V)] for v in range(V)])
    jf = lambda a: a if isinstance(a, float) else jnp.asarray(a)
    ref = jwf.WeakFormBlocks(
        A=tuple(map(jf, args[0])), B=tuple(map(jf, args[1])),
        C=tuple(tuple(map(jf, r)) for r in args[2]),
        D=tuple(tuple(map(jf, r)) for r in args[3]),
        E=tuple(tuple(map(jf, r)) for r in args[4])).to_dense()
    out = blocks_from_numpy(*args, "cpu").to_dense()
    for o, r in zip(out, ref):
        assert np.array_equal(o.numpy(), np.asarray(r))


def _physics_inputs(model):
    """(port model, reference model, params, u_qp, grad_qp, fields) of a
    live deck with seeded quadrature values."""
    from tests.test_torch_hcc import _params as hcc_params
    from tests.test_torch_pihna import _deck, _inputs
    from tests.test_torch_proteas_ripf import _proteas_params, _ripf_params
    from tests.torch_helpers import adpm_params

    rng = np.random.default_rng(29)
    Q, E = 5, 40
    if model == "pihna":
        u, grad = _inputs(Q=Q, E=E)
        return pihna, jpihna, _deck(True), u, grad, {}
    if model == "adpm":
        u = np.stack([1.0 + 0.01 * rng.standard_normal((Q, E)),
                      rng.uniform(0.0, 1.0, (Q, E)),
                      rng.uniform(0.0, 1.0, (Q, E))])
        tracts = rng.standard_normal((E, 3))
        tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
        return (adpm, jadpm, adpm_params("all"), u,
                rng.standard_normal((3, Q, 3, E)),
                {"tracts": tracts, "time": 1.5})
    if model == "proteas":
        u = rng.uniform(0.0, 0.9, (5, Q, E))
        return (proteas, jproteas, _proteas_params("all"), u,
                rng.standard_normal((5, Q, 3, E)),
                {"RTD": rng.uniform(0.0, 60.0, (Q, E))})
    if model == "ripf":
        u = np.stack([rng.uniform(-1000.0, 200.0, (Q, E)),
                      rng.uniform(-0.1, 1.2, (Q, E)),
                      rng.uniform(-0.1, 1.2, (Q, E))])
        gr = rng.standard_normal((Q, 3, E))
        fields = {"cc_dtime": rng.uniform(-3e-3, 3e-3, (Q, E)),
                  "fb_dtime": rng.uniform(-3e-3, 3e-3, (Q, E)),
                  "RT": rng.uniform(0.0, 70.0, (Q, E)),
                  "RT_grad_unit": gr / np.linalg.norm(gr, axis=1,
                                                      keepdims=True)}
        return (ripf, jripf, _ripf_params("all"), u,
                rng.standard_normal((3, Q, 3, E)), fields)
    u = rng.uniform(0.0, 0.5, (3, Q, E))
    return (hcc, jhcc, hcc_params("live"), u,
            rng.standard_normal((3, Q, 3, E)),
            {"grad_sigma": rng.standard_normal((Q, 3, E))})


@pytest.mark.parametrize("model", ["pihna", "adpm", "proteas", "ripf",
                                   "hcc"])
def test_physics_forms_match(model):
    """Each `*_physics` (the block form's to_dense) equals the reference's
    dense form, field by field (HCC's is written out densely there)."""
    mod, jmod, p, u, grad, fields = _physics_inputs(model)
    ref = getattr(jmod, f"{model}_physics")(
        jnp.asarray(u), jnp.asarray(grad),
        {k: v if isinstance(v, float) else jnp.asarray(v)
         for k, v in fields.items()}, p)
    out = getattr(mod, f"{model}_physics")(
        torch.as_tensor(u), torch.as_tensor(grad),
        {k: v if isinstance(v, float) else torch.as_tensor(v)
         for k, v in fields.items()}, p)
    assert isinstance(out, weakform.WeakForm)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        assert np.abs(o.numpy() - r).max() <= TOL * max(1.0,
                                                         np.abs(r).max())


@pytest.fixture(scope="module")
def tet_case():
    """A TET4 box with the live PIHNA deck, the reference's dense system
    and its directly solved first step (its eager assemble, unclamped)."""
    jm = jax_box_tet_mesh(2, 2, 2)
    m = mesh_from_reference(jm)
    p, u0 = pihna_case(m)
    jsys = JaxSystem(jm, 5, jpihna.pihna_physics, fast_gather="off")
    return jm, m, p, u0, jsys, reference_assembled_step(jsys, u0, {}, p)


def test_assemble_matches(tet_case):
    jm, m, p, u0, jsys, _ = tet_case
    s = TransientRDCSystem(m, 5, physics=pihna.pihna_physics, device="cpu",
                           ops=PLAIN_OPS)
    ref_v, ref_b = jsys.assemble(jnp.asarray(u0.T), {}, p)
    vals, b = s.assemble(u0.T, {}, p)
    assert np.array_equal(s.sp.rows, jsys.sp.rows)
    assert np.array_equal(s.sp.cols, jsys.sp.cols)
    assert rel(vals, ref_v) < TOL and rel(b, ref_b) < TOL


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_dense_step_matches(tet_case, precision):
    """The dense step equals the reference's assembled solution and the
    port's own qp step; a param that is not a plain number sends a
    system with a block form down the dense path too."""
    jm, m, p, u0, jsys, ref = tet_case
    kw = dict(rtol=1e-14, device="cpu", ops=PLAIN_OPS, precision=precision)
    dense = TransientRDCSystem(m, 5, physics=pihna.pihna_physics, **kw)
    both = TransientRDCSystem(m, 5, pihna.pihna_blocks,
                              physics=pihna.pihna_physics, **kw)
    st, _, res = dense.step(dense.initial_state(u0), params=p)
    assert float(res) <= 1e-14
    assert rel_l2(st["u_raw"].numpy(), ref) < 1e-10
    qp, _, _ = both.step(both.initial_state(u0), params=p)
    assert rel_l2(st["u"].numpy(), qp["u"].numpy()) < 1e-10
    p_tensor = {**p, "dt": torch.tensor(p["dt"], dtype=torch.float64)}
    via, _, _ = both.step(both.initial_state(u0), params=p_tensor)
    assert torch.equal(via["u"], st["u"])


def test_dense_options_follow_the_reference(tet_case):
    """run_steps needs the block form; precond_refresh reuses the dense
    inverse; a moving dense system steps on the coords it is given; the
    dense path applies no hanging-node constraints (the reference's
    _solve_clamped does not)."""
    jm, m, p, u0, _, _ = tet_case
    kw = dict(rtol=1e-14, device="cpu", ops=PLAIN_OPS)
    s = TransientRDCSystem(m, 5, physics=pihna.pihna_physics, **kw)
    st = s.initial_state(u0)
    with pytest.raises(ValueError, match="physics_blocks"):
        s.run_steps(st, 1, params=p)
    ref, _, _ = s.step(st, params=p)
    cons = TransientRDCSystem(m, 5, physics=pihna.pihna_physics,
                              constraints=np.array([[0, 1, 2]]), **kw)
    out, _, _ = cons.step(cons.initial_state(u0), params=p)
    assert torch.equal(out["u"], ref["u"])
    x = m.coords * 1.1
    moving = TransientRDCSystem(m, 5, physics=pihna.pihna_physics,
                                moving_mesh=True, **kw)
    fixed = TransientRDCSystem(m.with_coords(x), 5,
                               physics=pihna.pihna_physics, **kw)
    a, _, _ = moving.step(moving.initial_state(u0), params=p, coords=x)
    b, _, _ = fixed.step(fixed.initial_state(u0), params=p)
    assert torch.equal(a["u"], b["u"])
    lazy = TransientRDCSystem(m, 5, physics=pihna.pihna_physics,
                              precond_refresh=3, **kw)
    s1, _, _ = lazy.step(lazy.initial_state(u0), params=p)
    D1 = lazy._dinv_cache
    lazy.step(s1, params=p)
    assert lazy._dinv_cache is D1


def test_inverse_distance_interpolate_matches():
    rng = np.random.default_rng(17)
    nodes, data = rng.random((40, 3)), rng.random(40)
    xyz = rng.random((3, 7, 3))
    xyz[1, 4] = nodes[11]  # an exact hit takes the node's value
    for coeff in (2.0, 3.5):
        ref = np.asarray(jax_ida(jnp.asarray(xyz), jnp.asarray(nodes),
                                 jnp.asarray(data), coeff))
        out = inverse_distance_interpolate(torch.as_tensor(xyz),
                                           torch.as_tensor(nodes),
                                           torch.as_tensor(data), coeff)
        assert rel(out, ref) < TOL
        assert float(out[1, 4]) == data[11]
