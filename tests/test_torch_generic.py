"""The port's generic (non-affine) transient path against rdcfes_tpu on
HEX8: same seeded NumPy inputs through the JAX function and its
counterpart.

* interpolate_ue, block_rhs, qp_apply, block_diag in f64 within 1e-13 of
  the largest reference value (the port reduces over q, k, d with
  broadcast sums, the reference term by term: reassociation only), with
  every block live and with some absent;
* gather_interp_generic_plain (kernel K8's plain version) within 1e-13 of
  the reference's interpolate_ue of the gathered corners;
* apply_generic_plain (the plain version of kernel K6) equals
  interpolate_ue + qp_apply, within 1e-13 of the reference's, and within
  1e-5 (f32 reassociation) of the Pallas kernel qp_apply_fused itself, run
  in interpret mode on box_hex_mesh(8,8,8): 512 elements, the smallest
  tile that kernel takes, so nothing is padded;
* take_along_plain (K7's plain version) equals numpy's take_along_axis;
* 3 PIHNA steps on box_hex_mesh(3,3,3), mixed precision, rtol 1e-11: each
  step within 1e-10 relative L2 of the reference's own linear system for
  that step, built from its CPU-path functions and solved directly
  (tests/torch_helpers.reference_direct_step); precision="f64" with
  BiCGStab and GMRES lands on the same solution;
* 3 ADPM steps on the same mesh (taxis, so live D planes, and fields),
  each from the port's own previous state against the reference's direct
  solution: one step from a common state, never a trajectory.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.fem import pallas_apply as jpa
from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.models import adpm as jadpm
from rdcfes_tpu.models.pihna import pihna_blocks as jax_pihna_blocks
from rdcfes_tpu.models.pihna import pihna_physics
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

from rdcfes_tpu_torch.fem import assembly, kernels, weakform
from rdcfes_tpu_torch.mesh import box_hex_mesh
from rdcfes_tpu_torch.models import adpm
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.utils.convert import (blocks_from_numpy,
                                            fields_from_numpy)

from tests.torch_helpers import (NO_CLAMP, adpm_params, adpm_state,
                                 quick_compile, reference_direct_step, rel_l2)

V = 3   # species of the function tests' seeded blocks
TOL = 1e-13
RTOL = 1e-11
COPIES = 5 * 64  # mesh copies of the direct solves: PIHNA's V N on 3^3 hexes


def rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pattern(kind, v, w):
    """'all': every block live; 'some': a fixed sparse subset."""
    return kind == "all" or (v + 2 * w) % 3 == 0


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_blocks(A, B, C, D, E, dtype=jnp.float64):
    f = lambda a: a if isinstance(a, float) else jnp.asarray(a, dtype)
    return jwf.WeakFormBlocks(
        A=tuple(f(a) for a in A), B=tuple(f(b) for b in B),
        C=tuple(tuple(f(c) for c in r) for r in C),
        D=tuple(tuple(f(d) for d in r) for r in D),
        E=tuple(tuple(f(e) for e in r) for r in E))


def _random_blocks(rng, kind, Q, E):
    A = [rng.standard_normal((Q, E)) if v != 2 or kind == "all" else 0.0
         for v in range(V)]  # 'some': species 2 has no A
    B = [rng.standard_normal((Q, 3, E)) if _pattern(kind, v, 1) else 0.0
         for v in range(V)]
    mk = lambda tail, s: [[rng.standard_normal(tail)
                           if _pattern(kind, v, w + s) else 0.0
                           for w in range(V)] for v in range(V)]
    return (A, B, mk((Q, E), 0), mk((Q, 3, E), 1), mk((Q, E), 2))


def _hex_case(n, seed):
    """A jittered hex box (so the Jacobian differs per quadrature point),
    the reference's geometry factors as NumPy, seeded blocks and x."""
    mesh = jax_box_hex_mesh(n, n, n, bounds=((0, 2.0), (0, 3.0), (0, 2.5)))
    rng = np.random.default_rng(seed)
    coords = mesh.coords + 0.05 * rng.standard_normal(mesh.coords.shape)
    phi, JxW, dphi = jgeo.geometry_factors(
        jnp.asarray(coords), jnp.asarray(mesh.connectivity), "HEX8")
    Q, E = JxW.shape
    blocks = {k: _random_blocks(rng, k, Q, E) for k in ("all", "some")}
    x = rng.standard_normal((V, mesh.n_nodes))
    return dict(mesh=mesh, phi=phi, JxW=np.asarray(JxW),
                dphi=np.asarray(dphi), blocks=blocks, x=x,
                ue=x[:, mesh.connectivity.T])


@pytest.fixture(scope="module")
def case():
    return _hex_case(2, 17)


def test_interpolate_ue_matches(case):
    ref = jasm.interpolate_ue(jnp.asarray(case["ue"]), case["phi"],
                              jnp.asarray(case["dphi"]))
    out = assembly.interpolate_ue(_t(case["ue"]), case["phi"],
                                  _t(case["dphi"]))
    assert out[0].shape == (V, 8, case["mesh"].n_elems)
    assert out[1].shape == (V, 8, 3, case["mesh"].n_elems)
    for o, r in zip(out, ref):
        assert rel(o, r) < TOL


def test_gather_interp_generic_plain_matches(case):
    """K8's plain version (corner gather + interpolate_ue from the nodal
    x) against the reference's interpolate_ue of the gathered corners; on
    CPU tensors the wrapper is its plain version and launches nothing."""
    conn_T = torch.as_tensor(
        np.ascontiguousarray(case["mesh"].connectivity.T))
    ref = jasm.interpolate_ue(jnp.asarray(case["ue"]), case["phi"],
                              jnp.asarray(case["dphi"]))
    args = (_t(case["x"]), conn_T, case["phi"], _t(case["dphi"]))
    out = kernels.gather_interp_generic_plain(*args)
    for o, r in zip(out, ref):
        assert rel(o, r) < TOL
    before = kernels.launch_counts()
    for o, w in zip(out, kernels.gather_interp_generic(*args)):
        assert torch.equal(o, w)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("kind", ["all", "some"])
def test_block_rhs_matches(case, kind):
    blk = case["blocks"][kind]
    ref = jwf.block_rhs(_jax_blocks(*blk), case["phi"],
                        jnp.asarray(case["JxW"]), jnp.asarray(case["dphi"]))
    out = weakform.block_rhs(blocks_from_numpy(*blk, "cpu"), case["phi"],
                             _t(case["JxW"]), _t(case["dphi"]))
    assert rel(out, ref) < TOL
    if kind == "some":  # species 2 has neither A nor B: genuine zeros
        assert not np.asarray(ref)[2].any() and not out[2].any()


@pytest.mark.parametrize("kind", ["all", "some"])
def test_qp_apply_matches(case, kind):
    blk = case["blocks"][kind]
    x_qp, gx_qp = jasm.interpolate_ue(jnp.asarray(case["ue"]), case["phi"],
                                      jnp.asarray(case["dphi"]))
    ref = jwf.qp_apply(_jax_blocks(*blk), case["phi"],
                       jnp.asarray(case["JxW"]), jnp.asarray(case["dphi"]),
                       x_qp, gx_qp)
    out = weakform.qp_apply(blocks_from_numpy(*blk, "cpu"), case["phi"],
                            _t(case["JxW"]), _t(case["dphi"]), _t(x_qp),
                            _t(gx_qp))
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("kind", ["all", "some"])
def test_block_diag_matches(case, kind):
    blk = case["blocks"][kind]
    ref = jwf.block_diag(_jax_blocks(*blk), case["phi"],
                         jnp.asarray(case["JxW"]), jnp.asarray(case["dphi"]))
    out = weakform.block_diag(blocks_from_numpy(*blk, "cpu"), case["phi"],
                              _t(case["JxW"]), _t(case["dphi"]))
    assert out.shape == (V, V, 8, case["mesh"].n_elems)
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["all", "some"])
def test_apply_generic_plain_equals_module_functions(case, kind, dtype):
    m = case["mesh"]
    blk = case["blocks"][kind]
    wfb = blocks_from_numpy(*blk, "cpu", dtype=dtype)
    JxW, dphi = _t(case["JxW"], dtype), _t(case["dphi"], dtype)
    conn_T = torch.as_tensor(np.ascontiguousarray(m.connectivity.T))
    x = _t(case["x"], dtype)
    phi = case["phi"]
    st = kernels.stack_apply_generic(wfb)
    n_live = lambda b: sum(not isinstance(e, float) for r in b for e in r)
    assert (len(st.idxC), len(st.idxD), len(st.idxE)) == (
        n_live(wfb.C), n_live(wfb.D), n_live(wfb.E))
    assert st.E.shape == (len(st.idxE),) + tuple(JxW.shape)  # per-q planes
    Ye = kernels.apply_generic_plain(x, conn_T, phi, JxW, dphi, st)
    assert Ye.dtype == dtype
    x_qp, gx_qp = assembly.interpolate_ue(x[:, conn_T], phi, dphi)
    assert torch.equal(Ye, weakform.qp_apply(wfb, phi, JxW, dphi, x_qp,
                                             gx_qp))
    # on CPU tensors the wrapper is its plain version, and launches nothing
    before = kernels.launch_counts()
    assert torch.equal(kernels.apply_generic(x, conn_T, phi, JxW, dphi, st),
                       Ye)
    assert kernels.launch_counts() == before
    if dtype == torch.float64:
        jx_qp, jgx = jasm.interpolate_ue(jnp.asarray(case["ue"]), phi,
                                         jnp.asarray(case["dphi"]))
        ref = jwf.qp_apply(_jax_blocks(*blk), phi, jnp.asarray(case["JxW"]),
                           jnp.asarray(case["dphi"]), jx_qp, jgx)
        assert rel(Ye, ref) < TOL


def test_apply_generic_plain_matches_pallas_kernel_interpreted():
    """The TPU kernel itself (qp_apply_fused, interpret mode) on 512
    elements in f32 against K6's plain version: f32 reassociation only,
    within 1e-5 of the largest value."""
    c = _hex_case(8, 23)
    E = c["mesh"].n_elems
    assert E == 512
    blk = c["blocks"]["some"]
    f32 = jnp.float32
    stacks = jpa.stack_blocks(_jax_blocks(*blk, dtype=f32), E)
    ref = jpa.qp_apply_fused(stacks, c["phi"], jnp.asarray(c["JxW"], f32),
                             jnp.asarray(c["dphi"], f32),
                             jnp.asarray(c["ue"], f32), interpret=True)
    t32 = torch.float32
    wfb = blocks_from_numpy(*blk, "cpu", dtype=t32)
    conn_T = torch.as_tensor(np.ascontiguousarray(c["mesh"].connectivity.T))
    out = kernels.apply_generic_plain(
        _t(c["x"], t32), conn_T, c["phi"], _t(c["JxW"], t32),
        _t(c["dphi"], t32), kernels.stack_apply_generic(wfb))
    assert out.dtype == t32 and out.shape == (V, 8, E)
    assert rel(out, ref) < 1e-5


def test_take_along_plain_matches_numpy():
    """The calibration probe's lookup at its own shapes against the probe's
    own check (np.take_along_axis, scripts/microbench_calib.py:102)."""
    rng = np.random.default_rng(0)
    S, M = 192, 4608
    tbl = rng.standard_normal((S, 128)).astype(np.float32)
    idx = rng.integers(0, S, (M, 128)).astype(np.int32)
    ref = np.take_along_axis(tbl, idx, axis=0)
    out = kernels.take_along_plain(torch.as_tensor(tbl),
                                   torch.as_tensor(idx))
    assert out.dtype == torch.float32 and np.array_equal(out.numpy(), ref)
    before = kernels.launch_counts()
    assert torch.equal(kernels.take_along(torch.as_tensor(tbl),
                                          torch.as_tensor(idx)), out)
    assert kernels.launch_counts() == before


# ----------------------------------------------------------------------
# the HEX8 step
# ----------------------------------------------------------------------
def _pihna_case():
    mesh = box_hex_mesh(3, 3, 3)
    Kk = 2.39e5
    p = default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk,
             necrosis_v=300.0 / Kk, produce_c=-2.5, switch_c2h=1.0,
             switch_h2c=1.82, switch_h2n=0.5, diffuse_v=0.5,
             produce_v=10.0, secrete_a_c=2.77e-13, secrete_a_h=5.22e-10,
             decay_a=5678.4)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(0)
    u0 = np.zeros((mesh.n_nodes, 5))
    r2 = ((mesh.coords - 0.5) ** 2).sum(axis=1)
    u0[:, 1] = 2000 * np.exp(-r2 / 0.1)
    u0[:, 2] = 500 * np.exp(-r2 / 0.1)
    u0[:, 3] = 7200 * (1 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    return mesh, p, u0


@pytest.fixture(scope="module")
def pihna_hex():
    """The port's 3 mixed-precision steps, and for each the reference's
    direct solution from the same old state."""
    mesh, p, u0 = _pihna_case()
    jsys = JaxSystem(jax_box_hex_mesh(3, 3, 3), 5, pihna_physics,
                     physics_blocks=jax_pihna_blocks, fast_gather="off")
    s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=RTOL,
                           precision="mixed", device="cpu")
    st = s.initial_state(u0)
    steps = []
    for _ in range(3):
        ref_raw = reference_direct_step(jsys, jax_pihna_blocks,
                                        st["u"].numpy(), {}, p, COPIES)
        old = st
        st, its, res = s.step(st, params=p)
        steps.append((old, st, its, float(res), ref_raw))
    return mesh, p, steps


def test_hex8_pihna_steps_match_reference(pihna_hex):
    _, _, steps = pihna_hex
    for old, st, its, res, ref_raw in steps:
        assert its > 0 and res <= RTOL
        assert rel_l2(st["u_raw"].numpy(), ref_raw) < 1e-10
        assert rel_l2(st["u"].numpy(), np.maximum(ref_raw, 0.0)) < 1e-10
        assert torch.equal(st["u_old"], old["u"])
        assert (st["u"].numpy() >= 0).all()


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_hex8_f64_methods_match_reference(pihna_hex, method):
    """precision="f64": one f64 Krylov solve per step, from the second
    step's old state, lands on the reference's direct solution."""
    mesh, p, steps = pihna_hex
    old, _, _, _, ref_raw = steps[1]
    s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=1e-12,
                           precision="f64", method=method, device="cpu")
    st, its, res = s.step(old, params=p)
    assert its > 0 and float(res) <= 1e-12
    if method == "gmres":
        assert its % 30 == 0  # whole restart cycles are counted
    assert rel_l2(st["u_raw"].numpy(), ref_raw) < 1e-10


def test_hex8_run_steps_equals_steps(pihna_hex):
    mesh, p, steps = pihna_hex
    s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=RTOL,
                           precision="mixed", device="cpu")
    st, its, ress = s.run_steps(steps[0][0], 3, params=p)
    assert its.tolist() == [x[2] for x in steps]
    assert torch.equal(st["u"], steps[-1][1]["u"])
    assert float(ress.max()) <= RTOL


def test_hex8_adpm_steps_match_reference():
    bounds = ((0, 20.0),) * 3
    mesh = box_hex_mesh(3, 3, 3, bounds=bounds)
    p = adpm_params("all")
    u0, tracts = adpm_state(mesh, "all")
    jsys = JaxSystem(jax_box_hex_mesh(3, 3, 3, bounds=bounds), 3,
                     jadpm.adpm_physics, physics_blocks=jadpm.adpm_blocks,
                     fast_gather="off")
    s = TransientRDCSystem(mesh, 3, adpm.adpm_blocks, clamp=NO_CLAMP,
                           rtol=1e-11, precision="mixed", device="cpu")
    f = fields_from_numpy({"tracts": tracts, "time": 1.0}, s.device)
    jf = {"tracts": jnp.asarray(tracts), "time": 1.0}
    st = s.initial_state(u0)
    for _ in range(3):
        ref_raw = reference_direct_step(jsys, jadpm.adpm_blocks,
                                        st["u"].numpy(), jf, p, COPIES)
        st, its, res = s.step(st, fields=f, params=p)
        assert its > 0 and float(res) <= 1e-11
        assert rel_l2(st["u_raw"].numpy(), ref_raw) < 1e-10
