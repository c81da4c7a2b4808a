"""The port's ADPM model and the run_steps options it needs (fields,
scalar_traj, subcycle) against rdcfes_tpu, same seeded NumPy inputs on
both sides.

* every response function of models/response.py, at seeded values and at
  its kinks (the branch boundaries themselves), equal to the reference's
  within 1e-15 of the amplitude: the same comparisons and the same
  arithmetic;
* tract_gate and adpm_blocks block by block within 1e-13, with the same
  structural zeros; the test fields stay away from the gate's thresholds
  (d = +-omega), which flip on round-off;
* ADPM on box_tet_mesh(3,3,3), every term and the time-weighted decay
  active, against the reference's CPU path (fast_gather="off", f64
  BiCGStab): its run_steps(2, subcycle=2, scalar_traj=, field_update=)
  and the port's, state and history within 1e-10 relative L2, with the
  reference's aggregation (rdcfes_tpu/systems/transient.py:1104-1123:
  iterations summed per outer step, the last substep's residual,
  scalar_traj values held over the substeps); the same 4 substeps asked
  of the port as plain steps at dt/2; one step() against the reference's
  step(); choose_subcycle against the reference's from k0=2;
* the port's probe ladder from k0=1, subcycle="auto" and another
  field_update hook, on box_tet_mesh(2,2,2), against its own runs;
* ADPM's shipped rtol of 1e-9 for the taxis-active leg, pinned by
  PARITY.md section 10's local parity: along a 10-step trajectory of
  oracle/adpm_numpy.AdpmOracle (scipy direct solves) on a bench-matched
  box_tet_mesh(6,6,6), the port re-seeded from each oracle state takes one
  step whose relative L2 to the oracle's next state stays within 1e-8
  (no JAX).

The HEX8 steps of ADPM are in tests/test_torch_generic.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.models import adpm as jadpm
from rdcfes_tpu.models import response as jrf
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

from rdcfes_tpu_torch.mesh import box_tet_mesh
from rdcfes_tpu_torch.models import adpm
from rdcfes_tpu_torch.models import response as rf
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.utils.convert import fields_from_numpy

from tests.torch_helpers import (NO_CLAMP, adpm_params, adpm_state,
                                 quick_compile, rel_l2)

RTOL = 1e-11

# name -> parameter tuple; the kinks are p[1:] themselves
RESPONSES = {
    "pi_": (0.7, 0.2, 0.8), "sd_": (0.7, 0.2, 0.8),
    "deriv_sd_": (0.7, 0.2, 0.8), "sg_": (0.7, 0.2, 0.8),
    "deriv_sg_": (0.7, 0.2, 0.8), "tr_": (0.7, 0.1, 0.3, 0.6, 0.9),
    "deriv_tr_": (0.7, 0.1, 0.3, 0.6, 0.9), "bsi_": (1.0, 0.4, 0.05),
    "deriv_bsi_": (1.0, 0.4, 0.05), "bsd_": (1.0, 0.4, 0.05),
    "deriv_bsd_": (1.0, 0.4, 0.05),
}


@pytest.mark.parametrize("name", sorted(RESPONSES))
def test_response_function_matches(name):
    p = RESPONSES[name]
    rng = np.random.default_rng(3)
    C = np.concatenate([rng.uniform(-0.2, 1.2, 200), np.asarray(p[1:]),
                        np.nextafter(p[1:], 2.0), np.nextafter(p[1:], -2.0)])
    ref = np.asarray(getattr(jrf, name)(jnp.asarray(C), p))
    out = getattr(rf, name)(torch.as_tensor(C), p)
    assert out.dtype == torch.float64
    assert np.abs(out.numpy() - ref).max() <= 1e-15 * max(
        1.0, np.abs(ref).max())
    # a non-positive amplitude turns the function off
    off = getattr(rf, name)(torch.as_tensor(C), (0.0,) + p[1:])
    assert not off.any()
    assert not np.asarray(getattr(jrf, name)(jnp.asarray(C),
                                             (0.0,) + p[1:])).any()


def test_heaviside_and_tensor_parameters_match():
    x = np.array([-1.0, -0.0, 0.0, 1e-300, 2.0])
    assert np.array_equal(rf.heaviside(torch.as_tensor(x)).numpy(),
                          np.asarray(jrf.heaviside(jnp.asarray(x))))
    # a tensor amplitude gates elementwise, as the reference's array does
    C = np.linspace(0.0, 1.0, 11)
    cM = np.where(np.arange(11) % 2 == 0, 0.5, -1.0)
    out = rf.pi_(torch.as_tensor(C), (torch.as_tensor(cM), 0.2, 0.8))
    ref = jrf.pi_(jnp.asarray(C), (jnp.asarray(cM), 0.2, 0.8))
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_default_params_equal():
    assert adpm.default_params() == jadpm.default_params()
    assert adpm.ADPM_VARS == jadpm.ADPM_VARS


def test_tract_gate_matches():
    rng = np.random.default_rng(9)
    Q, E = 4, 50
    grad = rng.standard_normal((Q, 3, E))
    grad[:, :, :5] = 0.0          # vanishing gradient: no direction
    tr = rng.standard_normal((E, 3))
    tr /= np.linalg.norm(tr, axis=1, keepdims=True)
    tq = np.broadcast_to(tr.T[None], (Q, 3, E))
    for omega in (float(np.cos(np.deg2rad(89.9))), 0.5):
        ref = np.asarray(jadpm.tract_gate(jnp.asarray(grad), jnp.asarray(tq),
                                          omega))
        out = adpm.tract_gate(torch.as_tensor(grad),
                              torch.as_tensor(np.array(tq)), omega)
        assert np.array_equal(out.numpy(), ref)
        assert not ref[:, :, :5].any() and np.abs(ref).sum() > 0


@pytest.mark.parametrize("kind", ["all", "taxis", "defaults"])
def test_adpm_blocks_match(kind):
    mesh = jax_box_tet_mesh(2, 2, 2, bounds=((0, 20.0),) * 3)
    p = adpm_params(kind)
    rng = np.random.default_rng(13)
    Q, E = 5, mesh.n_elems
    u_qp = np.stack([1.0 + 0.01 * rng.standard_normal((Q, E)),
                     rng.uniform(0.0, 1.0, (Q, E)),
                     rng.uniform(0.0, 1.0, (Q, E))])
    grad = rng.standard_normal((3, Q, 3, E))
    _, tracts = adpm_state(mesh, kind)
    fields = {"tracts": tracts, "time": 1.5}
    ref = jadpm.adpm_blocks(jnp.asarray(u_qp), jnp.asarray(grad),
                            {"tracts": jnp.asarray(tracts), "time": 1.5}, p)
    out = adpm.adpm_blocks(torch.as_tensor(u_qp), torch.as_tensor(grad),
                           fields_from_numpy(fields, "cpu"), p)
    flat = lambda wfb: (list(wfb.A) + list(wfb.B)
                        + [b for t in (wfb.C, wfb.D, wfb.E) for r in t
                           for b in r])
    live = 0
    for o, r in zip(flat(out), flat(ref)):
        if isinstance(r, float):
            assert isinstance(o, float) and o == r == 0.0
        else:
            live += 1
            r = np.asarray(r)
            assert o.dtype == torch.float64 and tuple(o.shape) == r.shape
            assert np.abs(o.numpy() - r).max() <= 1e-13 * max(
                1.0, np.abs(r).max())
    # A (3) + B (2) + C, D, E blocks: the deck decides how many are live
    assert live == {"all": 3 + 2 + 5 + 2 + 2, "taxis": 3 + 2 + 3 + 2 + 1,
                    "defaults": 3 + 0 + 3 + 0 + 0}[kind]


# ----------------------------------------------------------------------
# steps
# ----------------------------------------------------------------------
TIMES = np.array([1.0, 1.5])


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def _time_hook(state, aux, tr):
    """field_update hook of both sides (jittable): `time` comes from the
    step's scalar_traj value, the carry counts the calls."""
    return {"time": tr["t"]}, aux + 1


@pytest.fixture(scope="module")
def tet_reference():
    """The reference on box_tet_mesh(3,3,3), f64 BiCGStab, its CPU path:
    run_steps of 2 outer steps with subcycle=2, a scalar_traj and a
    field_update hook (one scan program of 4 substeps at dt/2, `time`
    1.0, 1.0, 1.5, 1.5); choose_subcycle from k0=2 (its probe compiles the
    per-step program at dt/2, which the one `step` after it reuses)."""
    bounds = ((0, 20.0),) * 3
    mesh = box_tet_mesh(3, 3, 3, bounds=bounds)
    p = adpm_params("all")
    u0, tracts = adpm_state(mesh, "all")
    jsys = JaxSystem(jax_box_tet_mesh(3, 3, 3, bounds=bounds), 3,
                     jadpm.adpm_physics, physics_blocks=jadpm.adpm_blocks,
                     clamp=NO_CLAMP, precision="f64", fast_gather="off",
                     rtol=RTOL)
    half = {**p, "dt": p["dt"] / 2}
    jf = {"tracts": jnp.asarray(tracts)}
    st0 = jsys.initial_state(u0)
    st, its, ress, aux = jsys.run_steps(
        st0, 2, fields=jf, params=p, scalar_traj={"t": TIMES}, subcycle=2,
        field_update=_time_hook, field_aux=0)
    traj = {"time": TIMES}
    ks = (jsys.choose_subcycle(st0, fields=jf, params=p, scalar_traj=traj,
                               k0=2),
          jsys.choose_subcycle(st0, fields=jf, params=p, scalar_traj=traj,
                               k0=2, stall_factor=0.0, kmax=2))
    one, it1, _ = jsys.step(st0, fields={**jf, "time": TIMES[0]},
                            params=half)
    return dict(mesh=mesh, p=p, half=half, u0=u0, tracts=tracts,
                final=jsys.gather_state(st), its=np.asarray(its),
                ress=np.asarray(ress), aux=int(aux), ks=ks,
                one=jsys.gather_state(one), it1=int(it1))


def _tet_system(mesh):
    return TransientRDCSystem(mesh, 3, adpm.adpm_blocks, clamp=NO_CLAMP,
                              rtol=RTOL, precision="f64", device="cpu")


def test_adpm_tet4_steps_match_reference(tet_reference):
    r = tet_reference
    s = _tet_system(r["mesh"])
    f = fields_from_numpy({"tracts": r["tracts"]}, s.device)
    st0 = s.initial_state(r["u0"])
    # one step() against the reference's step()
    st, it, res = s.step(st0, fields={**f, "time": 1.0}, params=r["half"])
    assert float(res) <= RTOL and abs(it - r["it1"]) <= 2
    got = s.gather_state(st)
    for key in ("u", "u_old", "u_older", "u_raw"):
        assert rel_l2(got[key], r["one"][key]) < 1e-10, key
    # 4 steps at dt/2 against the reference's 4 substeps; the history it
    # returns is at substep spacing, so u_old and u_older are steps 3 and 2
    st, its, ress = s.run_steps(st0, 4, fields=f, params=r["half"],
                                scalar_traj={"time": np.repeat(TIMES, 2)})
    assert its.shape == (4,) and ress.shape == (4,)
    assert float(ress.max()) <= RTOL and r["ress"].max() <= RTOL
    # round-off at the solver's exit moves an iteration count by one or two
    assert np.abs(its.numpy().reshape(2, 2).sum(axis=1)
                  - r["its"]).max() <= 4
    got = s.gather_state(st)
    for key in ("u", "u_old", "u_older", "u_raw"):
        assert rel_l2(got[key], r["final"][key]) < 1e-10, key


def test_subcycle_and_scalar_traj_follow_reference_aggregation(
        tet_reference):
    r = tet_reference
    mesh, p, half, u0 = r["mesh"], r["p"], r["half"], r["u0"]
    s = _tet_system(mesh)
    f = fields_from_numpy({"tracts": r["tracts"]}, s.device)
    # the reference's own call: subcycle, scalar_traj and the hook at once
    st, its, ress, aux = s.run_steps(
        s.initial_state(u0), 2, fields=f, params=p, scalar_traj={"t": TIMES},
        subcycle=2, field_update=_time_hook, field_aux=0)
    assert its.shape == r["its"].shape == (2,)
    assert ress.shape == r["ress"].shape == (2,)
    assert np.abs(its.numpy() - r["its"]).max() <= 4
    assert float(ress.max()) <= RTOL and r["ress"].max() <= RTOL
    assert aux == r["aux"] == 4  # the hook ran once per substep
    got = s.gather_state(st)
    for key in ("u", "u_old", "u_older", "u_raw"):
        assert rel_l2(got[key], r["final"][key]) < 1e-10, key
    # iterations summed per outer step, the residual of the last substep
    st2, its2, ress2 = s.run_steps(s.initial_state(u0), 2, fields=f,
                                   params=p, scalar_traj={"time": TIMES},
                                   subcycle=2)
    _, its4, ress4 = s.run_steps(s.initial_state(u0), 4, fields=f,
                                 params=half,
                                 scalar_traj={"time": np.repeat(TIMES, 2)})
    assert torch.equal(st2["u"], st["u"])
    assert torch.equal(its2, its4.reshape(2, 2).sum(dim=1))
    assert torch.equal(ress2, ress4.reshape(2, 2)[:, -1])
    # a constant `time` in scalars instead of the trajectory differs
    st_c, _, _ = s.run_steps(s.initial_state(u0), 2, fields=f, params=p,
                             scalars={"time": 1.0}, subcycle=2)
    assert rel_l2(st_c["u"].numpy(), r["final"]["u"]) > 1e-9
    with pytest.raises(ValueError, match="scalar_traj"):
        s.run_steps(s.initial_state(u0), 2, fields=f, params=p,
                    scalar_traj={"time": np.ones(3)})


def test_choose_subcycle_matches_reference(tet_reference):
    """The probe ladder from k0=2 stops where the reference's does: at the
    first converging k, and at kmax when nothing meets the stall factor."""
    r = tet_reference
    s = _tet_system(r["mesh"])
    f = fields_from_numpy({"tracts": r["tracts"]}, s.device)
    st0 = s.initial_state(r["u0"])
    kw = dict(fields=f, params=r["p"], scalar_traj={"time": TIMES}, k0=2)
    assert (s.choose_subcycle(st0, **kw),
            s.choose_subcycle(st0, stall_factor=0.0, kmax=2, **kw)
            ) == r["ks"] == (2, 2)


def test_choose_subcycle_and_field_update():
    """subcycle="auto" probes dt, dt/2, ... for the first converging k; a
    field_update hook feeds each step's fields and carries its aux."""
    mesh = box_tet_mesh(2, 2, 2, bounds=((0, 20.0),) * 3)
    p = adpm_params("all")
    u0, tracts = adpm_state(mesh, "all")
    s = _tet_system(mesh)
    f = fields_from_numpy({"tracts": tracts, "time": 1.0}, s.device)
    st0 = s.initial_state(u0)
    assert s.choose_subcycle(st0, fields=f, params=p) == 1
    # a stall factor nothing meets sends the ladder to kmax
    assert s.choose_subcycle(st0, fields=f, params=p, stall_factor=0.0,
                             kmax=4) == 4
    assert s.choose_subcycle(st0, fields=f, params=p, k0=2) == 2
    a = s.run_steps(st0, 2, fields=f, params=p, subcycle="auto")
    b = s.run_steps(st0, 2, fields=f, params=p)
    assert torch.equal(a[0]["u"], b[0]["u"])

    def update(state, aux, tr, t0):
        return {"time": t0 + aux * tr["step"]}, aux + 1

    tracts_only = {"tracts": f["tracts"]}
    out = s.run_steps(st0, 2, fields=tracts_only, params=p,
                      scalar_traj={"step": np.array([0.25, 0.25])},
                      field_update=update, field_aux=0, field_args=(1.0,))
    assert len(out) == 4 and out[3] == 2
    ref = s.run_steps(st0, 2, fields=tracts_only, params=p,
                      scalar_traj={"time": np.array([1.0, 1.25])})
    assert torch.equal(out[0]["u"], ref[0]["u"])


def test_adpm_local_parity_at_shipped_rtol():
    """The taxis-active leg's settings (amplitude 50, dt 0.05, rtol 1e-9,
    precision "mixed", precond_refresh 10) re-seeded from each state of a
    10-step oracle trajectory: every step within 1e-8 relative L2 of the
    oracle's next state.  The box keeps the bench's element size (bounds
    scaled by n / 28, scripts/calibrate_adpm_rtol.py:35-40), so the taxis
    CFL and the conditioning are the bench's; the reference measured
    1.8e-9 worst at 28^3 over 60 steps (PARITY.md section 10)."""
    from oracle.adpm_numpy import AdpmOracle

    n, steps = 6, 10
    s = n / 28.0
    mesh = box_tet_mesh(n, n, n, bounds=((0, 150.0 * s), (0, 180.0 * s),
                                         (0, 150.0 * s)))
    p = adpm_params("taxis")
    rng = np.random.default_rng(0)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u = np.zeros((mesh.n_nodes, 3))
    u[:, 0] = 1.0
    u[:, 1] = 1e-3 * np.exp(-r2 / (2 * (20.0 * s) ** 2))
    u[:, 2] = 1e-4 * np.exp(-r2 / (2 * (15.0 * s) ** 2))
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    orc = AdpmOracle(mesh.coords, mesh.connectivity, tracts, p)
    sys_ = TransientRDCSystem(mesh, 3, adpm.adpm_blocks, rtol=1e-9,
                              precision="mixed", precond_refresh=10,
                              device="cpu")
    f = fields_from_numpy({"tracts": tracts, "time": 1.0}, sys_.device)
    worst = 0.0
    for _ in range(steps):
        st, _, res = sys_.step(sys_.initial_state(u), fields=f, params=p)
        u, _ = orc.step(u, time=1.0)
        assert float(res) <= 1e-9
        worst = max(worst, rel_l2(st["u"].numpy(), u))
    assert worst <= 1e-8
