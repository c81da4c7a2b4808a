"""The port's PROTEAS and RIPF models, the RIPF CSV row, the two cases, the
RIPF driver's field rebuild and two properties of TransientRDCSystem,
against rdcfes_tpu on the same seeded NumPy inputs:

* proteas_blocks and ripf_blocks block by block within 1e-13 of the
  largest reference value, with the same structural zeros, over decks
  that hit every branch: both heaviside gates and a clamped Kappa
  (PROTEAS); VT >= 1, the min_vacant cut, all three eps branches, the HU
  ramp and its ends, fb on both sides of omicro_fb_b (RIPF); and decks
  whose diffusivities are the literal 0.0;
* rt_dose_schedule at and around its day boundaries, equal;
* ripf_row and the generated RIPF and PROTEAS cases, byte-equal;
* the RIPF driver's quadrature-point fields through the system's gather
  + interpolation op (K1 on TET4, K8 on HEX8; here their plain
  versions) against the reference's interpolate_at_qp, within 1e-13;
* TransientRDCSystem built without `precision` solves in f64, as the
  reference's: six PIHNA steps equal within 1e-10 relative, with the
  same iteration counts;
* run_steps rebuilds the block-Jacobi inverse at i % precond_refresh
  over the whole call: the reference's run_steps(n, segment=n), within
  1e-12 at a loose rtol (1e-6), where the reference's segment=4 moves the
  state by 2.7e-9.  Both hold to one reference program.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu import cases as jcases
from rdcfes_tpu.fem.assembly import interpolate_at_qp as j_interpolate_at_qp
from rdcfes_tpu.fem.geometry import geometry_factors as j_geometry_factors
from rdcfes_tpu.io import csv_metrics as jcsv
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.models import proteas as jproteas
from rdcfes_tpu.models import ripf as jripf
from rdcfes_tpu.models.pihna import pihna_blocks as jax_pihna_blocks
from rdcfes_tpu.models.pihna import pihna_physics
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers.ripf import qp_fields
from rdcfes_tpu_torch.fem.kernels import PLAIN_OPS
from rdcfes_tpu_torch.io import csv_metrics
from rdcfes_tpu_torch.mesh import box_hex_mesh, box_tet_mesh
from rdcfes_tpu_torch.models import proteas, ripf
from rdcfes_tpu_torch.models.pihna import pihna_blocks
from rdcfes_tpu_torch.systems import TransientRDCSystem

from tests.torch_helpers import quick_compile, rel_l2


def _flat(wfb):
    return (list(wfb.A) + list(wfb.B)
            + [b for t in (wfb.C, wfb.D, wfb.E) for r in t for b in r])


def _check_blocks(out, ref) -> int:
    """Every block within 1e-13 of the largest reference value, the same
    structural zeros; returns the number of live blocks."""
    live = 0
    for i, (o, r) in enumerate(zip(_flat(out), _flat(ref))):
        if isinstance(r, float):
            assert isinstance(o, float) and o == r == 0.0, i
            continue
        live += 1
        r = np.asarray(r)
        o = o.numpy()
        assert o.dtype == np.float64 and o.shape == r.shape, i
        assert np.abs(o - r).max() <= 1e-13 * max(1.0, np.abs(r).max()), i
    return live


# ----------------------------------------------------------------------
# PROTEAS
# ----------------------------------------------------------------------
def _proteas_params(kind):
    p = jproteas.default_params()
    p.update({"dt": 0.05, "cells_total_capacity": 2.0,
              "radiotherapy_max_dosage": 60.0, "host_proliferation": 0.4,
              "host_vsc_threshold": 0.05, "tumour_diffusion": 0.1,
              "tumour_diffusion_host": 0.05, "tumour_proliferation": 0.5,
              "tumour_vsc_threshold": 0.12, "necrosis_slope": 2.0,
              "oedema_diffusion": 0.1, "oedema_vsc_threshold": 0.08,
              "oedema_RT_exp": 1.5})
    if kind == "no_cross":
        p["tumour_diffusion_host"] = 0.0
    elif kind == "no_diffusion":
        p.update(tumour_diffusion=0.0, tumour_diffusion_host=0.0,
                 oedema_diffusion=0.0)
    elif kind == "defaults":
        p = jproteas.default_params()
        p["dt"] = 0.05
    return {k: float(v) for k, v in p.items()}


@pytest.mark.parametrize("kind", ["all", "no_cross", "no_diffusion",
                                  "defaults"])
def test_proteas_blocks_match(kind):
    p = _proteas_params(kind)
    rng = np.random.default_rng(21)
    Q, E = 5, 60
    # T straddles T_max (Kappa clamped at 0 and 1 on some points); vsc
    # straddles every threshold, so both sides of each heaviside gate
    u = rng.uniform(0.0, 0.9, (5, Q, E))
    u[:, :, :6] *= -0.1
    u[:, :, 6:12] *= 4.0
    u[3] = rng.uniform(0.0, 0.2, (Q, E))
    grad = rng.standard_normal((5, Q, 3, E))
    rtd = rng.uniform(0.0, 60.0, (Q, E))
    ref = jproteas.proteas_blocks(jnp.asarray(u), jnp.asarray(grad),
                                  {"RTD": jnp.asarray(rtd)}, p)
    out = proteas.proteas_blocks(torch.as_tensor(u), torch.as_tensor(grad),
                                 {"RTD": torch.as_tensor(rtd)}, p)
    live = _check_blocks(out, ref)
    # A 5, B, C 18, D, E: each zero diffusivity drops its blocks
    assert live == {"all": 5 + 2 + 18 + 4 + 3, "no_cross": 5 + 2 + 18 + 4 + 2,
                    "no_diffusion": 5 + 0 + 18 + 0 + 0,
                    "defaults": 5 + 2 + 18 + 4 + 3}[kind]


def test_proteas_defaults_and_vars_equal():
    assert proteas.default_params() == jproteas.default_params()
    assert proteas.PROTEAS_VARS == jproteas.PROTEAS_VARS


# ----------------------------------------------------------------------
# RIPF
# ----------------------------------------------------------------------
def _ripf_params(kind):
    p = jripf.default_params()
    p.update(dt=0.1, volfr_stroma=0.3, volfr_parenchyma=0.2,
             volfr_exponent=2.5, volfr_min_vacant=1e-5, phi_tolerance=1e-3,
             cc_delta=0.0864, cc_delta_RT_a=0.3, cc_delta_RT_b=0.03,
             fb_lambda=0.01, fb_omega=0.1, fb_diffusion=1e-20,
             fb_haptotaxis=0.05, lambda_RT_r=56.0, omicro_RT_r=64.0)
    if kind == "all":
        p.update(phi_cc_build=2.0, phi_cc_decay=-1.5, phi_cc_rate=0.7,
                 phi_fb_build=3.0, phi_fb_decay=-2.5, phi_fb_rate=0.4,
                 cc_kappa=0.5, cc_kappa_RT_c=0.02, fb_omicro=0.3,
                 omicro_fb_b=0.4, fb_diffusion=0.02, fb_radiotaxis=0.01,
                 lambda_HU_r=-300.0)
    elif kind == "no_transport":
        p.update(fb_diffusion=0.0, fb_haptotaxis=0.0, fb_radiotaxis=0.0)
    return {k: float(v) for k, v in p.items()}


@pytest.mark.parametrize("kind,rates_in", [("all", "fields"),
                                           ("case", "params"),
                                           ("no_transport", "fields")])
def test_ripf_blocks_match(kind, rates_in):
    p = _ripf_params(kind)
    rng = np.random.default_rng(22)
    Q, E = 5, 80
    HU = rng.uniform(-1000.0, 200.0, (Q, E))   # the ramp, beyond it, > 0
    cc = rng.uniform(-0.1, 1.2, (Q, E))        # cc outside [0, 1) too
    fb = rng.uniform(-0.1, 1.2, (Q, E))        # on both sides of b
    cc[:, :10], fb[:, :10] = 0.3, 0.3          # VT >= 1: no vacancy
    cc[:, 10:20], fb[:, 10:20] = 0.25, 0.2496  # tau under min_vacant
    u = np.stack([HU, cc, fb])
    grad = rng.standard_normal((3, Q, 3, E))
    td = rng.uniform(-3e-3, 3e-3, (2, Q, E))   # all three eps branches
    gr = rng.standard_normal((Q, 3, E))
    fields = {"cc_dtime": td[0], "fb_dtime": td[1],
              "RT": rng.uniform(0.0, 70.0, (Q, E)),
              "RT_grad_unit": gr / np.linalg.norm(gr, axis=1, keepdims=True)}
    scalars = {}
    if rates_in == "fields":
        scalars = {k: p.pop(k) for k in ("lambda_RT_r", "omicro_RT_r")}
    ref = jripf.ripf_blocks(jnp.asarray(u), jnp.asarray(grad),
                            {**{k: jnp.asarray(v) for k, v in fields.items()},
                             **scalars}, p)
    out = ripf.ripf_blocks(torch.as_tensor(u), torch.as_tensor(grad),
                           {**{k: torch.as_tensor(v)
                               for k, v in fields.items()}, **scalars}, p)
    live = _check_blocks(out, ref)
    # A 3, B, C 8, D, E: the zero transport coefficients drop theirs
    assert live == {"all": 3 + 1 + 8 + 2 + 2, "case": 3 + 1 + 8 + 2 + 2,
                    "no_transport": 3 + 0 + 8 + 0 + 0}[kind]


def test_ripf_defaults_and_vars_equal():
    assert ripf.default_params() == jripf.default_params()
    assert ripf.RIPF_VARS == jripf.RIPF_VARS


def test_rt_dose_schedule_matches_across_days():
    bf, ff = 3, 2
    days = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    # (no time just below 0: a denormal, which XLA flushes to zero)
    times = np.concatenate([days, np.nextafter(days[1:], -1.0),
                            np.nextafter(days, 9.0), days + 0.5,
                            0.1 * np.arange(0, 61)])
    rng = np.random.default_rng(23)
    broad, focus = rng.uniform(0.0, 60.0, 40), rng.uniform(0.0, 16.0, 40)
    for t in times:
        ref = np.asarray(jripf.rt_dose_schedule(jnp.asarray(broad),
                                                jnp.asarray(focus), float(t),
                                                bf, ff))
        out = ripf.rt_dose_schedule(torch.as_tensor(broad),
                                    torch.as_tensor(focus), float(t), bf, ff)
        assert np.array_equal(out.numpy(), ref), t
    # broadcast over (times, nodes), as the driver's trajectories do
    ref = np.asarray(jripf.rt_dose_schedule(
        jnp.asarray(broad)[None], jnp.asarray(focus)[None],
        jnp.asarray(times)[:, None], float(bf), float(ff)))
    out = ripf.rt_dose_schedule(torch.as_tensor(broad)[None],
                                torch.as_tensor(focus)[None],
                                torch.as_tensor(times)[:, None], float(bf),
                                float(ff))
    assert np.array_equal(out.numpy(), ref)
    assert ref[:, 0].min() < ref[:, 0].max()  # the days change the dose


def test_ripf_row_byte_equal():
    mesh = jax_box_tet_mesh(3, 3, 3, bounds=((0, 250.0), (0, 180.0),
                                             (0, 250.0)))
    pmesh = box_tet_mesh(3, 3, 3, bounds=((0, 250.0), (0, 180.0),
                                          (0, 250.0)))
    rng = np.random.default_rng(24)
    ranges = {"range_cc_HU_min": -900.0, "range_cc_HU_max": 500.0,
              "range_cc_min": 0.05, "range_fb_HU_min": -700.0,
              "range_fb_HU_max": 1000.0, "range_fb_min": 0.1}
    a, b = io.StringIO(), io.StringIO()
    for t in (0.0, 0.1, 2.5):
        u = np.stack([rng.uniform(-1000.0, 600.0, mesh.n_nodes),
                      rng.uniform(0.0, 0.3, mesh.n_nodes),
                      rng.uniform(0.0, 0.3, mesh.n_nodes)], axis=1)
        u[:20, 0] = -800.0  # some elements inside every window
        jcsv.ripf_row(a, mesh, u, t, ranges)
        csv_metrics.ripf_row(b, pmesh, u, t, ranges)
    assert b.getvalue() == a.getvalue()
    rows = [r.split(",") for r in a.getvalue().splitlines()]
    assert len(rows) == 3 and all(float(r[1]) > 0 for r in rows)


@pytest.mark.parametrize("name", ["make_ripf_case", "make_proteas_case"])
def test_generated_cases_match_reference(name, tmp_path):
    a, b = tmp_path / "port", tmp_path / "ref"
    getattr(cases, name)(str(a), n=3, n_steps=7)
    getattr(jcases, name)(str(b), n=3, n_steps=7)
    names = sorted(p.name for p in b.iterdir())
    assert sorted(p.name for p in a.iterdir()) == names
    for n in names:
        x, y = (a / n).read_text(), (b / n).read_text()
        if n == "Makefile":
            assert "python3 -m rdcfes_tpu_torch.cli -m " in x
            x = x.replace("rdcfes_tpu_torch.cli", "rdcfes_tpu.cli")
        assert x == y, n


@pytest.mark.parametrize("name", ["make_pihna_case", "make_adpm_case",
                                  "make_ripf_case", "make_proteas_case"])
def test_mixed_and_second_order_cases_raise(name, tmp_path):
    """The mixed and second-order cases, which raised for RIPF and
    PROTEAS until they were ported, are written as the reference writes
    them for all four models (the Makefile names the port's CLI)."""
    for i, kw in enumerate(({"mixed": True}, {"order": 2})):
        a, b = tmp_path / f"a{i}", tmp_path / f"b{i}"
        getattr(cases, name)(str(a), n=3, n_steps=2, **kw)
        getattr(jcases, name)(str(b), n=3, n_steps=2, **kw)
        for f in sorted(p.name for p in b.iterdir()):
            x, y = (a / f).read_text(), (b / f).read_text()
            assert x.replace("rdcfes_tpu_torch.cli", "rdcfes_tpu.cli") \
                == y, (kw, f)


@pytest.mark.parametrize("elem", ["TET4", "HEX8"])
def test_ripf_qp_fields_match_interpolate_at_qp(elem):
    """The driver's field rebuild through the system's op (K1 on TET4, K8
    on HEX8), run through PLAIN_OPS, against the reference driver's
    interpolate_at_qp and its unit-gradient formula."""
    bounds = ((0, 250.0), (0, 180.0), (0, 250.0))
    if elem == "TET4":
        mesh, jm = box_tet_mesh(2, 2, 2, bounds=bounds), jax_box_tet_mesh(
            2, 2, 2, bounds=bounds)
    else:
        mesh, jm = box_hex_mesh(2, 2, 2, bounds=bounds), jax_box_hex_mesh(
            2, 2, 2, bounds=bounds)
    s = TransientRDCSystem(mesh, 3, ripf.ripf_blocks, device="cpu",
                           ops=PLAIN_OPS)
    rng = np.random.default_rng(25)
    nodal = rng.standard_normal((3, mesh.n_nodes))
    nodal[2] = rng.uniform(0.0, 60.0, mesh.n_nodes)
    nodal[2] = 0.0  # no dose first: a zero gradient, the unit vector 0
    for _ in range(2):
        out = qp_fields(s, torch.as_tensor(nodal))
        phi, JxW, dphi = j_geometry_factors(jnp.asarray(jm.coords),
                                            jnp.asarray(jm.connectivity),
                                            elem)
        vals, grads = j_interpolate_at_qp(
            jnp.asarray(nodal), jnp.asarray(jm.connectivity.T), phi, dphi)
        g = grads[2]
        norm = jnp.linalg.norm(g, axis=-2, keepdims=True)
        ref = {"cc_dtime": vals[0], "fb_dtime": vals[1], "RT": vals[2],
               "RT_grad_unit": jnp.where(
                   norm > 0.0, g / jnp.where(norm == 0, 1.0, norm), 0.0)}
        for k, r in ref.items():
            r = np.asarray(r)
            o = out[k].numpy()
            assert o.shape == r.shape, k
            assert np.abs(o - r).max() <= 1e-13 * max(1.0, np.abs(r).max()), k
        nodal[2] = rng.uniform(0.0, 60.0, mesh.n_nodes)
    assert np.abs(np.asarray(ref["RT_grad_unit"])).max() > 0.5


# ----------------------------------------------------------------------
# TransientRDCSystem: the default precision and the refresh schedule
# ----------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def _pihna_case():
    """PIHNA on box_tet_mesh(2,2,2) with the bench deck's growth,
    vascular and angiogenic terms and without its necrosis, switching and
    secretion terms: fewer live blocks, a cheaper reference compile."""
    mesh = box_tet_mesh(2, 2, 2)
    Kk = 2.39e5
    p = {"dt": 0.1, "cells_min_capacity": 1.0, "cells_max_capacity": Kk,
         "cells_max_capacity_exponent": 3.0, "cytokines_max_capacity": 1e-8,
         "necrosis_c": 0.0, "necrosis_h": 0.0, "necrosis_v": 0.0,
         "diffuse_c": 0.0, "taxis_c": 0.0, "diffuse_h": 0.0, "taxis_h": 0.0,
         "produce_c": -2.5, "switch_c2h": 0.0, "switch_h2c": 0.0,
         "switch_h2n": 0.0, "diffuse_v": 0.5, "taxis_v": 0.0,
         "produce_v": 10.0, "secrete_a_c": 0.0, "secrete_a_h": 0.0,
         "uptake_a_v": 0.0, "decay_a": 5678.4}
    rng = np.random.default_rng(26)
    r2 = ((mesh.coords - 0.5) ** 2).sum(axis=1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 2000 * np.exp(-r2 / 0.1)
    u0[:, 2] = 500 * np.exp(-r2 / 0.1)
    u0[:, 3] = 7200 * (1 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    return mesh, p, u0


N_STEPS, REFRESH, RTOL = 6, 3, 1e-6


@pytest.fixture(scope="module")
def reference_run():
    """One reference program for both tests below: the system built
    without `precision`, refreshing every 3 steps at a loose rtol (1e-6),
    run_steps(6, segment=6)."""
    mesh, p, u0 = _pihna_case()
    jsys = JaxSystem(jax_box_tet_mesh(2, 2, 2), 5, pihna_physics,
                     physics_blocks=jax_pihna_blocks, fast_gather="off",
                     precond_refresh=REFRESH, rtol=RTOL)
    ref, jits, _ = jsys.run_steps(jsys.initial_state(u0), N_STEPS, params=p,
                                  segment=N_STEPS)
    return jsys.precision, ref, np.asarray(jits)


def _port_run(**kw):
    mesh, p, u0 = _pihna_case()
    s = TransientRDCSystem(mesh, 5, pihna_blocks, device="cpu",
                           precond_refresh=REFRESH, rtol=RTOL, **kw)
    out, its, res = s.run_steps(s.initial_state(u0), N_STEPS, params=p)
    return s, out, its, res


def test_default_precision_is_f64_as_the_reference(reference_run):
    precision, ref, jits = reference_run
    s, out, its, res = _port_run()
    assert s.precision == precision == "f64"
    assert float(res.max()) <= s.rtol
    assert its.tolist() == jits.tolist()
    assert rel_l2(out["u"].numpy(), np.asarray(ref["u"])) <= 1e-10


def test_precond_refresh_schedule_is_the_reference_single_segment(
        reference_run):
    _, ref, jits = reference_run
    _, out, its, _ = _port_run(precision="f64")
    assert its.tolist() == jits.tolist()
    for k in ("u", "u_raw"):
        assert rel_l2(out[k].numpy(), np.asarray(ref[k])) <= 1e-12, k
