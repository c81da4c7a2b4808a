"""The port's dtype=torch.float32 serving mode against rdcfes_tpu's
dtype=jnp.float32 (rdcfes_tpu/systems/transient.py:231-238,
rdcfes_tpu/systems/mixed.py:71-84), same seeded NumPy inputs on both
sides, f32 in both packages.  The reference runs its CPU path
(fast_gather off, so it never enters its Pallas code) under
tests/torch_helpers.quick_compile; the port runs the plain versions of its
kernels.  Every bar is 1e-5 relative L2 per step: both packages solve to
the f32 floor of the rtol (1e-6), and the two f32 runs differ by their
solvers' truncation and f32 round-off (measured 3e-8 to 2e-6).

* the dense path, as tests/test_transient.py:121-140: logistic physics on
  box_tet_mesh(3,3,3), 5 steps, against the reference's f32 steps, and
  against the port's f64 run at that test's rtol 2e-5, atol 1e-6;
* the affine qp path with PIHNA's blocks on box_tet_mesh(3,3,3), 3 steps;
* the generic qp path on box_hex_mesh(2,2,2) with a one-species block
  form (the reference's HEX8 step program compiles in ~12 s with one
  species, 50-110 s with five), 2 steps;
* MixedTransientRDCSystem on box_mixed_mesh(5,3,3), 2 steps of the qp and
  of the dense path against the reference's mixed f32 step (a dense
  program);
* the rules: the rtol floor, no refine_mixed in f32, a bad dtype raises,
  the state and the tables stay f32, f32 constraints hold, and the f32
  kernel wrappers take their plain versions on CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import WeakForm as JaxWeakForm
from rdcfes_tpu.fem.weakform import WeakFormBlocks as JaxBlocks
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.models.pihna import pihna_blocks as jax_pihna_blocks
from rdcfes_tpu.models.pihna import pihna_physics as jax_pihna_physics
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem
from rdcfes_tpu.systems.mixed import MixedTransientRDCSystem as JaxMixed

from rdcfes_tpu_torch.fem import kernels
from rdcfes_tpu_torch.fem.weakform import WeakForm, WeakFormBlocks
from rdcfes_tpu_torch.mesh import box_hex_mesh, box_mixed_mesh, box_tet_mesh
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.systems import (MixedTransientRDCSystem,
                                      TransientRDCSystem)
from rdcfes_tpu_torch.systems import transient as transient_mod
from rdcfes_tpu_torch.utils.convert import state_from_numpy

from tests.torch_helpers import quick_compile, rel_l2

F32, F64 = torch.float32, torch.float64
BAR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def logistic_physics(xp, form, D=0.2, rho=1.5):
    """u_t = div(D grad u) + rho u (1 - u), linearized CN, as a dense
    WeakForm of package `xp` (jnp or torch): tests/test_transient.py's
    logistic_rd_physics."""

    def physics(u_qp, grad_qp, fields, params):
        dt2 = params["dt"] / 2.0
        u = u_qp[0]
        return form(A=(u + dt2 * rho * u * (1.0 - u))[None],
                    B=(-dt2 * D) * grad_qp[:1],
                    C=(1.0 - dt2 * rho * (1.0 - 2.0 * u))[None, None],
                    E=(dt2 * D) * xp.ones_like(u)[None, None])

    return physics


def logistic_blocks(xp, blocks, D=0.2, rho=1.5):
    """The same form as WeakFormBlocks of one species."""

    def fn(u_qp, grad_qp, fields, params):
        dt2 = params["dt"] / 2.0
        u = u_qp[0]
        return blocks(A=(u + dt2 * rho * u * (1.0 - u),),
                      B=((-dt2 * D) * grad_qp[0],),
                      C=((1.0 - dt2 * rho * (1.0 - 2.0 * u),),),
                      D=((0.0,),), E=(((dt2 * D) * xp.ones_like(u),),))

    return fn


def _u0(mesh):
    """Seeded logistic state (N, 1) in [0, 0.2)."""
    return 0.2 * np.random.default_rng(0).random((mesh.n_nodes, 1))


def _reference_steps(jsys, u0, n, params, **kw):
    """The reference's n steps from u0 in f32 (state u per step, NumPy)."""
    st = jsys.initial_state(u0.astype(np.float32))
    out = []
    for _ in range(n):
        st, _, res = jsys.step(st, params=params, **kw)
        assert float(res) <= 1e-6
        out.append(np.asarray(st["u"]))
        assert out[-1].dtype == np.float32
    return out


def _port_steps(s, u0, n, params, **kw):
    st = s.initial_state(u0.astype(np.float32))
    out = []
    for _ in range(n):
        st, _, res = s.step(st, params=params, **kw)
        assert st["u"].dtype == F32 and float(res) <= 1e-6
        out.append(st["u"].numpy())
    return out


def _pihna_case(n=3, bounds=None):
    """PIHNA's bench deck and a seeded state on box_tet_mesh(n, n, n):
    tests/test_torch_slice.py's case on the unit cube, or with `bounds`
    chip_smoke.py's bench_case state on that box."""
    mesh = (box_tet_mesh(n, n, n) if bounds is None
            else box_tet_mesh(n, n, n, bounds=bounds))
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
    if bounds is None:
        r2 = ((mesh.coords - 0.5) ** 2).sum(axis=1)
        w1 = w2 = 0.1
    else:
        r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
        w1, w2 = 2 * 25.0**2, 2 * 30.0**2
    u0[:, 1] = 2000 * np.exp(-r2 / w1)
    u0[:, 2] = 500 * np.exp(-r2 / w2)
    u0[:, 3] = 7200 * (1 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    return mesh, p, u0


# ----------------------------------------------------------------------
# against the reference's f32 mode
# ----------------------------------------------------------------------
def test_dense_f32_matches_reference_and_tracks_f64():
    """(a) tests/test_transient.py:121-140 in both packages: 5 f32 steps
    of the dense path, each within 1e-5 of the reference's, and the last
    within rtol 2e-5, atol 1e-6 of the port's f64 run."""
    mesh = box_tet_mesh(3, 3, 3)
    u0 = _u0(mesh)
    dt32 = np.float32(0.05)
    ref = _reference_steps(
        JaxSystem(jax_box_tet_mesh(3, 3, 3), 1,
                  logistic_physics(jnp, JaxWeakForm), dtype=jnp.float32),
        u0, 5, {"dt": dt32})
    phys = logistic_physics(torch, WeakForm)
    got = _port_steps(TransientRDCSystem(mesh, 1, physics=phys, dtype=F32,
                                         device="cpu"),
                      u0, 5, {"dt": float(dt32)})
    for k, (a, b) in enumerate(zip(got, ref)):
        assert rel_l2(a, b) <= BAR, k
    s64 = TransientRDCSystem(mesh, 1, physics=phys, device="cpu")
    st64 = s64.initial_state(u0)
    for _ in range(5):
        st64, _, _ = s64.step(st64, params={"dt": 0.05})
    np.testing.assert_allclose(st64["u"].numpy(), got[-1], rtol=2e-5,
                               atol=1e-6)


def test_pihna_qp_f32_matches_reference():
    """(b) the affine qp path (K1, K2, K3 f32, K4 f32) with PIHNA's bench
    blocks: 3 f32 steps within 1e-5 of the reference's f32 steps."""
    mesh, p, u0 = _pihna_case()
    ref = _reference_steps(
        JaxSystem(jax_box_tet_mesh(3, 3, 3), 5, jax_pihna_physics,
                  physics_blocks=jax_pihna_blocks, dtype=jnp.float32,
                  fast_gather="off", rtol=3e-11), u0, 3, p)
    got = _port_steps(TransientRDCSystem(mesh, 5, pihna_blocks, rtol=3e-11,
                                         dtype=F32, device="cpu"),
                      u0, 3, p)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert rel_l2(a, b) <= BAR, k


def test_generic_qp_f32_matches_reference():
    """(c) the generic qp path (K8, K6 f32, K4 f32) on HEX8 with a
    one-species block form: 2 f32 steps within 1e-5 of the reference's."""
    mesh = box_hex_mesh(2, 2, 2)
    u0 = _u0(mesh)
    p = {"dt": 0.05}
    ref = _reference_steps(
        JaxSystem(jax_box_hex_mesh(2, 2, 2), 1,
                  logistic_physics(jnp, JaxWeakForm),
                  physics_blocks=logistic_blocks(jnp, JaxBlocks),
                  dtype=jnp.float32, fast_gather="off"), u0, 2, p)
    got = _port_steps(TransientRDCSystem(
        mesh, 1, logistic_blocks(torch, WeakFormBlocks), dtype=F32,
        device="cpu"), u0, 2, p)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert rel_l2(a, b) <= BAR, k


@pytest.fixture(scope="module")
def mixed_reference():
    """The reference's MixedTransientRDCSystem in f32 (a dense program
    over the HEX8, PYRAMID5 and TET4 blocks): 2 steps from the seeded
    state."""
    mesh = box_mixed_mesh(5, 3, 3)
    u0 = _u0(mesh)
    ref = _reference_steps(
        JaxMixed(jax_box_mixed_mesh(5, 3, 3), 1,
                 logistic_physics(jnp, JaxWeakForm), dtype=jnp.float32),
        u0, 2, {"dt": 0.05})
    return mesh, u0, ref


@pytest.mark.parametrize("path", ["qp", "dense"])
def test_mixed_f32_matches_reference(mixed_reference, path):
    """(d) MixedTransientRDCSystem(dtype=f32): the qp path (K1-K3 on the
    TET4 block, K8 and K6 on the others) and the dense path, 2 steps each
    within 1e-5 of the reference's mixed f32 steps."""
    mesh, u0, ref = mixed_reference
    kw = ({"physics_blocks": logistic_blocks(torch, WeakFormBlocks)}
          if path == "qp" else
          {"physics": logistic_physics(torch, WeakForm)})
    s = MixedTransientRDCSystem(mesh, 1, dtype=F32, device="cpu", **kw)
    assert s.geoms[0].JxW.dtype == F32
    got = _port_steps(s, u0, 2, {"dt": 0.05})
    for k, (a, b) in enumerate(zip(got, ref)):
        assert rel_l2(a, b) <= BAR, k


# ----------------------------------------------------------------------
# the rules of the f32 mode
# ----------------------------------------------------------------------
def test_f32_rtol_floor():
    """f32 floors the rtol at 1e-6 (rdcfes_tpu/systems/transient.py:
    237-238); f64 keeps it."""
    mesh, _, _ = _pihna_case(2)
    for cls, m in ((TransientRDCSystem, mesh),
                   (MixedTransientRDCSystem, box_mixed_mesh(3, 2, 2))):
        assert cls(m, 5, pihna_blocks, rtol=3e-11, dtype=F32,
                   device="cpu").rtol == 1e-6
        assert cls(m, 5, pihna_blocks, rtol=1e-4, dtype=F32,
                   device="cpu").rtol == 1e-4
        assert cls(m, 5, pihna_blocks, rtol=3e-11,
                   device="cpu").rtol == 3e-11


def test_f32_mixed_precision_runs_the_plain_solve(monkeypatch):
    """precision="mixed" in f32 never calls refine_mixed (reference
    :521): the f64 system calls it once a step, the f32 one not at all,
    on the qp and the dense path."""
    calls = []
    real = transient_mod.refine_mixed

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(transient_mod, "refine_mixed", counted)
    mesh, p, u0 = _pihna_case(2)
    phys = logistic_physics(torch, WeakForm)
    for dt, n in ((F64, 2), (F32, 0)):
        calls.clear()
        s = TransientRDCSystem(mesh, 5, pihna_blocks, precision="mixed",
                               dtype=dt, device="cpu")
        st, _, res = s.step(s.initial_state(u0), params=p)
        d = TransientRDCSystem(mesh, 1, physics=phys, precision="mixed",
                               dtype=dt, device="cpu")
        d.step(d.initial_state(_u0(mesh)), params={"dt": 0.05})
        assert len(calls) == n
        assert st["u"].dtype == dt and float(res) <= s.rtol


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32, "float32", np.float32])
def test_bad_dtype_raises(dtype):
    mesh, _, _ = _pihna_case(2)
    with pytest.raises(ValueError, match="dtype"):
        TransientRDCSystem(mesh, 5, pihna_blocks, dtype=dtype, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        MixedTransientRDCSystem(box_mixed_mesh(3, 2, 2), 5, pihna_blocks,
                                dtype=dtype, device="cpu")


def test_state_and_tables_stay_f32():
    """initial_state, step, run_steps (its residuals too), choose_subcycle,
    gather_state (NumPy f32, as the reference's), scatter_state, the
    geometry (one tensor for both casts), a moving mesh's geometry and
    the dense path's assemble: all f32."""
    mesh, p, u0 = _pihna_case(2)
    s = TransientRDCSystem(mesh, 5, pihna_blocks, dtype=F32, device="cpu",
                           precond_refresh=2)
    g = s.geom
    assert g.JxW.dtype == F32 and g.dphi.dtype == F32
    assert g.JxW32 is g.JxW and g.dphi32 is g.dphi
    st = s.initial_state(u0)
    assert all(v.dtype == F32 for v in st.values())
    st, _, res = s.step(st, params=p)
    assert all(v.dtype == F32 for v in st.values()) and res.dtype == F32
    st, its, ress = s.run_steps(st, 2, params=p)
    assert all(v.dtype == F32 for v in st.values())
    assert ress.dtype == F32 and its.dtype == torch.int64
    assert s.run_steps(st, 0, params=p)[2].dtype == F32
    assert s.choose_subcycle(st, params=p) == 1
    host = s.gather_state(st)
    assert all(v.dtype == np.float32 for v in host.values())
    back = s.scatter_state({k: v.astype(np.float64) for k, v in
                            host.items()})
    assert all(v.dtype == F32 for v in back.values())
    assert torch.equal(back["u"], st["u"])
    assert state_from_numpy(host, "cpu", F32)["u"].dtype == F32
    moving = TransientRDCSystem(mesh, 5, pihna_blocks, dtype=F32,
                                device="cpu", moving_mesh=True)
    gm = moving._geom_from_coords(mesh.coords * 1.1)
    assert gm.JxW.dtype == F32 and gm.dphi.dtype == F32
    sm, _, _ = moving.step(moving.initial_state(u0), params=p,
                           coords=mesh.coords * 1.1)
    assert sm["u"].dtype == F32
    values, b = s.assemble(st["u"].T, {}, p)
    assert values.dtype == F32 and b.dtype == F32
    # the reference's assemble_scipy gives f64 matrices in f32 mode too
    mx = MixedTransientRDCSystem(box_mixed_mesh(3, 2, 2), 1,
                                 physics=logistic_physics(torch, WeakForm),
                                 dtype=F32, device="cpu")
    A, rhs = mx.assemble_scipy(torch.full((1, mx.mesh.n_nodes), 0.1),
                               {}, {"dt": 0.05})
    assert A.dtype == np.float64 and rhs.dtype == np.float64


def test_f32_constraints_hold():
    """constraints= in f32: the hanging value is the mean of its masters
    after the step, and Constraints' algebra keeps f32."""
    mesh, p, u0 = _pihna_case(2)
    s = TransientRDCSystem(mesh, 5, pihna_blocks, dtype=F32, device="cpu",
                           constraints=np.array([[0, 1, 2]]))
    st, _, res = s.step(s.initial_state(u0), params=p)
    u = st["u"]
    assert u.dtype == F32 and float(res) <= s.rtol
    assert torch.equal(u[0], 0.5 * (u[1] + u[2]))
    c = s.cons
    x = torch.arange(10, dtype=F32).reshape(2, 5)
    D = torch.ones((2, 2, 5), dtype=F32)
    for y in (c.c_apply(x), c.ct_fold(x), c.pin(x), c.fold_diagonal(D)):
        assert y.dtype == F32


def test_f32_wrappers_take_the_plain_versions_on_the_cpu():
    """K1, K2 and K8 on f32 CPU tensors: their plain versions, in f32; an
    instance exists for f32 and f64 only."""
    mesh, p, u0 = _pihna_case(2)
    s = TransientRDCSystem(mesh, 5, pihna_blocks, dtype=F32, device="cpu")
    u = torch.as_tensor(u0.T.copy(), dtype=F32)
    uq, gx = kernels.gather_interp_affine(u, s.conn_T, s.phi, s.geom.dphi)
    assert uq.dtype == F32 and gx.dtype == F32
    gq = gx[:, None].expand(5, uq.shape[1], 3, gx.shape[-1])
    st = kernels.stack_rhs(pihna_blocks(uq, gq, {}, p))
    Fe = kernels.rhs_affine(st, s.geom.JxW, s.phi, s.geom.dphi)
    assert Fe.dtype == F32
    assert torch.equal(Fe, kernels.rhs_affine_plain(st, s.geom.JxW, s.phi,
                                                    s.geom.dphi))
    h = TransientRDCSystem(box_hex_mesh(2, 2, 2), 1,
                           logistic_blocks(torch, WeakFormBlocks), dtype=F32,
                           device="cpu")
    x = torch.rand((1, h.mesh.n_nodes), dtype=F32)
    out = kernels.gather_interp_generic(x, h.conn_T, h.phi, h.geom.dphi)
    ref = kernels.gather_interp_generic_plain(x, h.conn_T, h.phi,
                                              h.geom.dphi)
    assert all(o.dtype == F32 and torch.equal(o, r)
               for o, r in zip(out, ref))
    for dt in (F32, F64):
        assert kernels._float_tag("k", dt) in ("f32", "f64")
    with pytest.raises(TypeError):
        kernels._float_tag("k", torch.float16)


def _drift(n: int, steps: int) -> None:
    """Print, per step, both packages' f32-to-f64 relative L2 and the f32
    port-to-reference one on box_tet_mesh(n) with brain bounds and the
    PIHNA bench deck and state (_pihna_case with chip_smoke.py's BRAIN
    bounds), f64 at rtol 3e-11.  Not a test: it compiles four reference
    step programs."""
    brain = ((0, 150.0), (0, 180.0), (0, 150.0))
    mesh, p, u0 = _pihna_case(n, brain)
    runs = {}
    with quick_compile():
        for name, dt in (("ref32", jnp.float32), ("ref64", jnp.float64)):
            js = JaxSystem(jax_box_tet_mesh(n, n, n, bounds=brain), 5,
                           jax_pihna_physics,
                           physics_blocks=jax_pihna_blocks, dtype=dt,
                           fast_gather="off", rtol=3e-11)
            st = js.initial_state(u0.astype(dt))
            runs[name] = []
            for _ in range(steps):
                st, _, _ = js.step(st, params=p)
                runs[name].append(np.asarray(st["u"], dtype=np.float64))
    for name, dt in (("port32", F32), ("port64", F64)):
        s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=3e-11, dtype=dt,
                               device="cpu")
        st = s.initial_state(u0)
        runs[name] = []
        for _ in range(steps):
            st, _, _ = s.step(st, params=p)
            runs[name].append(st["u"].double().numpy())
    for k in range(steps):
        print(f"step {k + 1}: reference f32-f64 "
              f"{rel_l2(runs['ref32'][k], runs['ref64'][k]):.3e}, port "
              f"f32-f64 {rel_l2(runs['port32'][k], runs['port64'][k]):.3e}, "
              f"f32 port-reference "
              f"{rel_l2(runs['port32'][k], runs['ref32'][k]):.3e}")


if __name__ == "__main__":
    # python -m tests.test_torch_f32 [n] [steps]
    import sys

    _drift(*(int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2
           else (6, 25))
