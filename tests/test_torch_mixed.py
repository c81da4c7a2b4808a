"""The port's mixed-element meshes (HEX8 + PYRAMID5 + TET4, and PRISM6)
against rdcfes_tpu on the same seeded NumPy inputs
(np.random.default_rng(0) unless said).

* the PRISM6 and PYRAMID5 element tables equal to the reference's
  (within 1e-15), geometry_factors per type within 1e-13 relative;
* box_mixed_mesh(5,3,3) arrays equal, the Gmsh write byte-equal to the
  reference's `dumps` and the read round-trip (native parser path and
  NumPy parser), a MIXED VTU frame and the PIHNA / ADPM / RIPF CSV rows
  byte-equal;
* the plain K6 and K8 (apply_generic_plain, gather_interp_generic_plain)
  at PYRAMID5 (5, 8) and PRISM6 (6, 8) within 1e-13 of the reference's
  qp_apply and interpolate_ue;
* one MixedTransientRDCSystem step on box_mixed_mesh(5,3,3) (0-30 mm),
  PIHNA with five species and ADPM with a per-block tracts field, held
  per species (the error over the species' largest value) to the
  equilibrated dense solve of the reference's
  MixedTransientRDCSystem.assemble_scipy (the recipe of
  tests/test_mixed.py:155-183): f64 at rtol 1e-14 within 1e-8 per
  species and 1e-10 relative L2, and at the reference test's own
  settings (mixed, its default rtol 1e-12) within its 1e-8 on PIHNA and
  4e-8 on ADPM (Tau, 1e4 times smaller than PrP, lands 1.9e-8 from it,
  the reference's own step under quick_compile 1.8e-8: the Krylov stop
  measures all species in one norm; `python -m tests.test_torch_mixed`
  prints both packages' readings); a single-block TET4 MixedMesh, and a two-block split of
  the same tets, step as TransientRDCSystem does (within 1e-12);
* the PIHNA and ADPM drivers on make_*_case(n=3, n_steps=2, mixed=True)
  at solver/linear/tolerance 1e-14 (ADPM at the taxis amplitude 50, as
  chip_smoke.py's driver runs): the checkpointed state equal to the
  system stepped directly, the CSV rows and the last VTU frame
  byte-equal to the reference's writers on that state; the PIHNA case
  with an AMR deck adapts and runs on.

The reference's mixed step program is never compiled: assemble_scipy
and the element functions run eagerly.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import elements as jel
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.io import csv_metrics as jcsv
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.models.adpm import adpm_physics
from rdcfes_tpu.models.pihna import pihna_physics
from rdcfes_tpu.systems import MixedTransientRDCSystem as JaxMixed

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import adpm as dadpm
from rdcfes_tpu_torch.drivers import pihna as dpihna
from rdcfes_tpu_torch.fem import elements, geometry, kernels
from rdcfes_tpu_torch.io import csv_metrics, vtu
from rdcfes_tpu_torch.io.getpot import Deck
from rdcfes_tpu_torch.mesh import (MeshBlock, MixedMesh, box_mixed_mesh,
                                   gmsh)
from rdcfes_tpu_torch.models.adpm import adpm_blocks
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.systems import (MixedTransientRDCSystem,
                                      TransientRDCSystem)
from rdcfes_tpu_torch.utils.convert import (blocks_from_numpy,
                                            mesh_from_reference,
                                            mixed_mesh_from_arrays)

from tests.torch_helpers import quick_compile, rel_l2

B30 = ((0, 30.0),) * 3


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _prism_conn(hex_conn):
    """Each hex cell split into two PRISM6 (bottom triangles
    counterclockwise seen from above)."""
    return np.concatenate([hex_conn[:, [0, 1, 2, 4, 5, 6]],
                           hex_conn[:, [0, 2, 3, 4, 6, 7]]])


def _type_block(elem_type, rng):
    """(coords, conn) of a jittered block of elem_type."""
    if elem_type == "PRISM6":
        m = jax_box_hex_mesh(3, 2, 2)
        coords, conn = m.coords, _prism_conn(m.connectivity)
    else:
        m = jax_box_mixed_mesh(5, 3, 3)
        b = next(b for b in m.blocks if b.elem_type == elem_type)
        coords, conn = m.coords, b.connectivity
    return coords + 0.02 * rng.standard_normal(coords.shape), conn


@pytest.mark.parametrize("elem_type", ["PRISM6", "PYRAMID5"])
def test_element_tables_match(elem_type):
    pts, wts = jel.quadrature(elem_type)
    tp, tw = elements.quadrature(elem_type)
    assert np.abs(tp - pts).max() <= 1e-15 and np.abs(tw - wts).max() <= 1e-15
    rng = np.random.default_rng(0)
    P = rng.uniform(0.05, 0.3, (7, 3))
    for fn in ("shape_functions", "shape_gradients"):
        a = getattr(elements, fn)(elem_type, P)
        b = getattr(jel, fn)(elem_type, P)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-15
    for a, b in zip(elements.tabulate(elem_type), jel.tabulate(elem_type)):
        assert np.abs(a - b).max() <= 1e-15


_GEOMETRY = {}


def _reference_geometry(elem_type):
    """(rng after the block, coords, conn, phi, JxW, dphi) of a jittered
    block of elem_type, the geometry from the reference (computed once)."""
    if elem_type not in _GEOMETRY:
        rng = np.random.default_rng(0)
        coords, conn = _type_block(elem_type, rng)
        _GEOMETRY[elem_type] = (rng, coords, conn) + jgeo.geometry_factors(
            jnp.asarray(coords), jnp.asarray(conn), elem_type)
    return _GEOMETRY[elem_type]


@pytest.mark.parametrize("elem_type", ["PRISM6", "PYRAMID5"])
def test_geometry_factors_match(elem_type):
    _, coords, conn, phi, JxW, dphi = _reference_geometry(elem_type)
    tphi, tJxW, tdphi = geometry.geometry_factors(
        torch.as_tensor(coords), torch.as_tensor(conn), elem_type)
    assert np.array_equal(tphi, phi)
    assert rel(tJxW, JxW) <= 1e-13 and rel(tdphi, dphi) <= 1e-13


def test_box_mixed_mesh_matches():
    a, b = jax_box_mixed_mesh(5, 3, 3), box_mixed_mesh(5, 3, 3)
    assert b.elem_type == "MIXED" and b.n_elems == a.n_elems
    for name in ("coords", "boundary_faces", "boundary_block",
                 "boundary_elem", "boundary_side", "boundary_id",
                 "subdomain_id"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for ba, bb in zip(a.blocks, b.blocks):
        assert ba.elem_type == bb.elem_type
        assert np.array_equal(ba.connectivity, bb.connectivity)
    assert np.array_equal(a.element_volumes(), b.element_volumes())
    assert np.isclose(b.element_volumes().sum(), 1.0)
    assert a.print_info() == b.print_info()
    moved = b.with_coords(b.coords * 2.0)
    assert np.isclose(moved.element_volumes().sum(), 8.0)
    # the reference's mesh moved across, and arrays put together again
    c = mesh_from_reference(a)
    assert isinstance(c, MixedMesh) and gmsh.dumps(c) == jgmsh.dumps(a)
    d = mixed_mesh_from_arrays(b.coords, [(x.elem_type, x.connectivity,
                                           x.subdomain_id)
                                          for x in b.blocks])
    assert np.array_equal(d.boundary_faces, b.boundary_faces)
    with pytest.raises(ValueError):
        box_mixed_mesh(2, 2, 2)
    with pytest.raises(ValueError):
        MeshBlock("TET10", np.zeros((1, 10), np.int32))
    with pytest.raises(ValueError):
        MeshBlock("HEX8", np.zeros((1, 6), np.int32))


def test_gmsh_mixed_write_and_read(tmp_path):
    ref = jax_box_mixed_mesh(5, 3, 3)
    ref.boundary_id[:] = np.arange(len(ref.boundary_id)) % 6
    port = mesh_from_reference(ref)
    text = jgmsh.dumps(ref)
    assert gmsh.dumps(port) == text
    path = str(tmp_path / "mixed.msh")
    with open(path, "w") as f:
        f.write(text)
    for m in (gmsh.read(path), gmsh.read_numpy(path)):
        assert m.elem_type == "MIXED" and gmsh.dumps(m) == text
        assert [b.elem_type for b in m.blocks] == ["HEX8", "PYRAMID5",
                                                    "TET4"]
        assert np.array_equal(m.boundary_id, ref.boundary_id)
    # a file with PRISM6 (the hexes split) reads as the reference reads it
    pm = MixedMesh(coords=port.coords, blocks=[MeshBlock(
        "PRISM6", _prism_conn(port.blocks[0].connectivity))]
        + port.blocks[1:])
    with open(path, "w") as f:
        f.write(gmsh.dumps(pm))
    a, b = gmsh.read(path), jgmsh.read(path)
    assert gmsh.dumps(a) == jgmsh.dumps(b)
    assert np.isclose(a.element_volumes().sum(), 1.0)


def test_vtu_and_csv_rows_match(tmp_path):
    ref = jax_box_mixed_mesh(5, 3, 3)
    for b in ref.blocks:
        mid = ref.coords[b.connectivity].mean(axis=1)
        b.subdomain_id[:] = np.where(mid[:, 0] < 0.5, 10, 20)
    port = mesh_from_reference(ref)
    rng = np.random.default_rng(0)
    N, E = ref.n_nodes, ref.n_elems
    u = rng.random((N, 5)) * np.array([1e3, 2e3, 1e3, 8e3, 1e-9])
    s = rng.random(E)
    assert np.array_equal(vtu.elemental_to_nodal(port, s),
                          jvtu.elemental_to_nodal(ref, s))
    fields = [("n", u[:, 0]), ("S", vtu.elemental_to_nodal(port, s))]
    jvtu.write_vtu(str(tmp_path / "a.vtu"), ref, fields,
                   cell_fields=[("s", s)])
    vtu.write_vtu(str(tmp_path / "b.vtu"), port, fields,
                  cell_fields=[("s", s)])
    assert (tmp_path / "a.vtu").read_text() == (tmp_path / "b.vtu").read_text()
    import io

    p = {"cells_max_capacity": 2.39e5}
    for k in ("active_tumor", "necrotic", "vascularity", "total_cell"):
        p[f"range_{k}_min"], p[f"range_{k}_max"] = 500.0, 1e12
    p["range_total_cell_min"] = 1e-3
    r = {"range_A_b_min": 0.3, "range_A_b_max": 1e12,
         "range_Tau_min": 0.5, "range_Tau_max": 1e12,
         "range_cc_HU_min": 100.0, "range_cc_HU_max": 900.0,
         "range_cc_min": 0.2, "range_fb_HU_min": 50.0,
         "range_fb_HU_max": 700.0, "range_fb_min": 0.1}
    elem_avg = rng.random((E, 2))
    for fn, args in (("pihna_row", (u, 2.5, p)),
                     ("adpm_row", (u[:, :3] / 1e3, 2.5, r, elem_avg)),
                     ("ripf_row", (u[:, :3] / 1e3, 2.5, r))):
        x, y = io.StringIO(), io.StringIO()
        getattr(jcsv, fn)(x, ref, *args)
        getattr(csv_metrics, fn)(y, port, *args)
        assert x.getvalue() == y.getvalue(), fn


@pytest.mark.parametrize("elem_type", ["PYRAMID5", "PRISM6"])
def test_plain_kernels_match_reference(elem_type):
    """apply_generic_plain (K6's plain version) and
    gather_interp_generic_plain (K8's) at this type's (K, Q), against
    the reference's interpolate_ue + qp_apply, every block live but a
    pattern."""
    rng, coords, conn, phi, JxW, dphi = _reference_geometry(elem_type)
    rng = np.random.default_rng(1)
    Q, E = JxW.shape
    V = 3
    on = lambda v, w: (v + 2 * w) % 3 != 1
    mk = lambda tail, s: [[rng.standard_normal(tail) if on(v, w + s)
                           else 0.0 for w in range(V)] for v in range(V)]
    C, D, Ee = mk((Q, E), 0), mk((Q, 3, E), 1), mk((Q, E), 2)
    x = rng.standard_normal((V, len(coords)))
    f = lambda a: a if isinstance(a, float) else jnp.asarray(a)
    jw = jwf.WeakFormBlocks(A=(0.0,) * V, B=(0.0,) * V,
                            C=tuple(tuple(f(c) for c in r) for r in C),
                            D=tuple(tuple(f(c) for c in r) for r in D),
                            E=tuple(tuple(f(c) for c in r) for r in Ee))
    x_qp, gx = jasm.interpolate_ue(jnp.asarray(x[:, conn.T]), phi, dphi)
    ref = jwf.qp_apply(jw, phi, JxW, dphi, x_qp, gx)
    conn_T = torch.as_tensor(np.ascontiguousarray(conn.T))
    tw = blocks_from_numpy([rng.standard_normal((Q, E))] * V, [0.0] * V,
                           C, D, Ee, "cpu")
    st = kernels.stack_apply_generic(tw)
    tJxW, tdphi, tx = (torch.as_tensor(np.asarray(a))
                       for a in (JxW, dphi, x))
    Ye = kernels.apply_generic(tx, conn_T, phi, tJxW, tdphi, st)
    assert Ye.shape == (V, conn.shape[1], E) and rel(Ye, ref) <= 1e-13
    out = kernels.gather_interp_generic(tx, conn_T, phi, tdphi)
    assert rel(out[0], x_qp) <= 1e-13 and rel(out[1], gx) <= 1e-13


def _pihna_params():
    Kk = 2.39e5
    p = default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500 / Kk, necrosis_h=200 / Kk, necrosis_v=300 / Kk,
             produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82,
             switch_h2n=0.5, diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0,
             taxis_h=4e-5, diffuse_v=0.5, taxis_v=1e-4, produce_v=10.0,
             secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, uptake_a_v=1e-3,
             decay_a=5678.4)
    return {k: float(v) for k, v in p.items()}


def _adpm_setup(mesh):
    """tests/test_mixed.py's ADPM taxis-active deck and state (seed 3)."""
    from rdcfes_tpu_torch.models.adpm import default_params as adpm_defaults

    p = adpm_defaults()
    p.update(dt=0.05,
             decay_PrP=1e-4, decay_PrP_pulse0=0.01, decay_PrP_pulse1=10.0,
             taxis1_A_b=50.0, taxis1_A_b_pulse0=-1.0, taxis1_A_b_pulse1=0.01,
             taxis1_Tau=50.0, taxis1_Tau_pulse0=-1.0, taxis1_Tau_pulse1=0.01,
             decay_Tau=10.0, decay_Tau_pulse0=0.0005, decay_Tau_pulse1=1e20,
             diffuse_A_b=2e-4, diffuse_A_b_pulse0=-1.0,
             diffuse_A_b_pulse1=1e20)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    N = mesh.n_nodes
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0 = np.stack([np.ones(N), 1e-3 * np.exp(-r2 / (2 * 8.0**2)),
                   1e-4 * np.exp(-r2 / (2 * 6.0**2))], axis=1)
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    return p, u0, tracts


def _dense_solve(A, rhs, u0):
    """The equilibrated dense solve of tests/test_mixed.py:166-175."""
    N, V = u0.shape
    svar = np.abs(u0).max(axis=0) + 1e-30
    Scol = np.concatenate([np.full(N, s) for s in svar])
    Ad = A.toarray() * Scol[None, :]
    rrow = 1.0 / (np.abs(Ad).max(axis=1) + 1e-300)
    y = np.linalg.solve(Ad * rrow[:, None], rhs * rrow)
    return (y * Scol).reshape(V, N).T


def _species_errors(u, u_ref):
    """Each species' largest error over its largest value."""
    scale = np.abs(u_ref).max(axis=0) + 1e-30
    return np.abs(u - u_ref).max(axis=0) / scale


def _per_species(u, u_ref):
    return float(_species_errors(u, u_ref).max())


@functools.lru_cache(maxsize=None)
def _reference_operator(model):
    """The step case of `model` and the reference's eager assemble_scipy
    there, made once a module run: (ref_mesh, mesh, params, u0, reference
    fields, port fields, the reference's physics, the port's blocks, A,
    rhs)."""
    ref_mesh = jax_box_mixed_mesh(5, 3, 3, bounds=B30)
    mesh = mesh_from_reference(ref_mesh)
    if model == "pihna":
        p = _pihna_params()
        rng = np.random.default_rng(0)
        u0 = np.abs(rng.random((mesh.n_nodes, 5))) * np.array(
            [1., 100., 50., 500., 1e-10])
        jfields, fields, phys, blocks = {}, {}, pihna_physics, pihna_blocks
    else:
        p, u0, tracts = _adpm_setup(mesh)
        jfields = {"tracts": jnp.asarray(tracts), "time": 1.0}
        fields = {"tracts": torch.as_tensor(tracts), "time": 1.0}
        phys, blocks = adpm_physics, adpm_blocks
    V = u0.shape[1]
    A, rhs = JaxMixed(ref_mesh, V, phys).assemble_scipy(u0.T, jfields, p)
    return ref_mesh, mesh, p, u0, jfields, fields, phys, blocks, A, rhs


def _step_case(model):
    """The one-step case of `model` on box_mixed_mesh(5,3,3) (0-30 mm):
    (ref_mesh, mesh, params, u0, reference fields, port fields, the
    reference's physics, the port's blocks, the dense solve u_ref)."""
    case = _reference_operator(model)
    A, rhs, u0 = case[8], case[9], case[3]
    return case[:8] + (_dense_solve(A, rhs, u0),)


@pytest.mark.parametrize("model", ["pihna", "adpm"])
def test_mixed_step_matches_dense_solve(model):
    """One MixedTransientRDCSystem step against the dense solve of the
    reference's assemble_scipy, per species: f64 at rtol 1e-14 within
    1e-8 (and 1e-10 relative L2 over the state), mixed at the reference
    test's rtol 1e-12 within 1e-8 on PIHNA and 4e-8 on ADPM (its tracts
    sliced per block)."""
    (ref_mesh, mesh, p, u0, jfields, fields, phys, blocks,
     u_ref) = _step_case(model)
    V, kw = u0.shape[1], {}
    # per-species bars (the error over each species' own largest value):
    # the reference's 1e-8 except ADPM's mixed one, set from the
    # readings, since the Krylov stop measures all species in one norm
    # and ADPM's Tau is 1e4 times smaller than its PrP.  The readings
    # (`python -m tests.test_torch_mixed`), the port's / the reference's
    # own step under quick_compile, the largest over species: PIHNA f64
    # 9.7e-12 / 9.7e-12, mixed 1.2e-10 / 2.1e-10; ADPM (PrP, A_b, Tau)
    # f64 3.9e-15, 5.2e-11, 4.3e-9 / 3.7e-15, 5.2e-11, 4.3e-9, mixed
    # 1.4e-12, 2.7e-9, 1.9e-8 / 9.0e-13, 4.1e-9, 1.8e-8
    species_bar = {("pihna", "f64"): 1e-8, ("pihna", "mixed"): 1e-8,
                   ("adpm", "f64"): 1e-8, ("adpm", "mixed"): 4e-8}
    for precision, rtol in (("f64", 1e-14), ("mixed", 1e-12)):
        s = MixedTransientRDCSystem(mesh, V, blocks, precision=precision,
                                    rtol=rtol, device="cpu", **kw)
        st, iters, res = s.step(s.initial_state(u0), fields=fields,
                                params=p)
        assert float(res) <= rtol
        u = st["u_raw"].numpy()
        err = _per_species(u, u_ref)
        assert err <= species_bar[model, precision], (precision, err)
        if precision == "f64":
            assert rel_l2(u, u_ref) <= 1e-10
    if model == "pihna":
        return
    # run_steps is the chain of step calls, `time` from scalar_traj
    s = MixedTransientRDCSystem(mesh, V, blocks, precision="mixed",
                                rtol=3e-11, device="cpu", **kw)
    f = {"tracts": fields["tracts"]}
    a, its, ress = s.run_steps(s.initial_state(u0), 2, fields=f, params=p,
                               scalar_traj={"time": np.array([1.0, 1.05])})
    b = s.initial_state(u0)
    for t in (1.0, 1.05):
        b, _, _ = s.step(b, fields=f, params=p, scalars={"time": t})
    assert its.shape == (2,) and ress.shape == (2,)
    assert torch.equal(a["u"], b["u"]) and torch.equal(a["u_old"],
                                                       b["u_old"])


@pytest.mark.parametrize("model", ["pihna", "adpm"])
def test_mixed_dense_step_matches_dense_solve(model):
    """One MixedTransientRDCSystem step on the dense path (physics=, the
    port's own pihna_physics / adpm_physics: one Ke per block, their
    applies restricted by the one table) against the same dense solve of
    the reference's assemble_scipy, at the qp step's bars: f64 at rtol
    1e-14 within 1e-8 per species and 1e-10 relative L2, mixed at rtol
    1e-12 within 1e-8 (PIHNA) and 4e-8 (ADPM) per species."""
    from rdcfes_tpu_torch.models.adpm import adpm_physics as port_adpm
    from rdcfes_tpu_torch.models.pihna import pihna_physics as port_pihna

    (_, mesh, p, u0, _, fields, _, _, u_ref) = _step_case(model)
    physics = port_pihna if model == "pihna" else port_adpm
    species_bar = {("pihna", "f64"): 1e-8, ("pihna", "mixed"): 1e-8,
                   ("adpm", "f64"): 1e-8, ("adpm", "mixed"): 4e-8}
    for precision, rtol in (("f64", 1e-14), ("mixed", 1e-12)):
        s = MixedTransientRDCSystem(mesh, u0.shape[1], physics=physics,
                                    precision=precision, rtol=rtol,
                                    device="cpu")
        st, _, res = s.step(s.initial_state(u0), fields=fields, params=p)
        assert float(res) <= rtol
        u = st["u_raw"].numpy()
        err = _per_species(u, u_ref)
        assert err <= species_bar[model, precision], (precision, err)
        if precision == "f64":
            assert rel_l2(u, u_ref) <= 1e-10


@pytest.mark.parametrize("model", ["pihna", "adpm"])
def test_assemble_scipy_matches_reference(model):
    """The port's MixedTransientRDCSystem.assemble_scipy (its blocks'
    dense element matrices, from the block form's to_dense) against the
    reference's on the same box_mixed_mesh(5,3,3) case (HEX8, PYRAMID5
    and TET4 blocks), within 1e-13 of the largest entry."""
    (_, mesh, p, u0, _, fields, _, blocks, A_ref,
     rhs_ref) = _reference_operator(model)
    A, rhs = MixedTransientRDCSystem(
        mesh, u0.shape[1], blocks, device="cpu").assemble_scipy(
            u0.T, fields, p)
    assert A.shape == A_ref.shape
    assert abs(A - A_ref).max() <= 1e-13 * abs(A_ref).max()
    assert np.abs(rhs - rhs_ref).max() <= 1e-13 * np.abs(rhs_ref).max()


def test_single_block_mixed_matches_transient_system():
    """A MixedMesh of one TET4 block steps as TransientRDCSystem on the
    same mesh does, and a two-block split of the same tets too (within
    1e-12): the sum over blocks is the single-type operator."""
    t = jax_box_tet_mesh(3, 3, 3, bounds=B30)
    p = _pihna_params()
    rng = np.random.default_rng(0)
    u0 = np.abs(rng.random((t.n_nodes, 5))) * np.array(
        [1., 100., 50., 500., 1e-10])
    ref = TransientRDCSystem(mesh_from_reference(t), 5, pihna_blocks,
                             precision="mixed", rtol=1e-12, device="cpu")
    half = t.n_elems // 2
    one = MixedMesh(coords=t.coords, blocks=[MeshBlock("TET4",
                                                       t.connectivity)])
    two = MixedMesh(coords=t.coords, blocks=[
        MeshBlock("TET4", t.connectivity[:half]),
        MeshBlock("TET4", t.connectivity[half:])])
    sr = ref.initial_state(u0)
    systems = [MixedTransientRDCSystem(m, 5, pihna_blocks,
                                       precision="mixed", rtol=1e-12,
                                       device="cpu") for m in (one, two)]
    states = [s.initial_state(u0) for s in systems]
    sr, _, _ = ref.step(sr, params=p)
    states = [s.step(st, params=p)[0] for s, st in zip(systems, states)]
    for st in states:
        d = (st["u"] - sr["u"]).norm() / sr["u"].norm()
        assert float(d) <= 1e-12


def test_mixed_system_options():
    """Tuple fields select their block's entry, elemental fields are
    sliced; constraints build the Constraints of the single-type system
    (empty rows none); a moving mesh asks for coords; a single-type mesh
    is refused."""
    mesh = box_mixed_mesh(3, 2, 2)
    s = MixedTransientRDCSystem(mesh, 5, pihna_blocks, device="cpu")
    E = mesh.n_elems
    el = torch.arange(E)
    nb = [b.n_elems for b in mesh.blocks]
    f = s._fields_for_block(1, {"t": el, "q": ("a", "b", "c"), "x": 2.0,
                                "nodal": torch.zeros(mesh.n_nodes)})
    assert torch.equal(f["t"], el[nb[0]:nb[0] + nb[1]])
    assert f["q"] == "b" and f["x"] == 2.0
    assert f["nodal"].shape == (mesh.n_nodes,)
    # a moving mesh needs the coords of every step (its step is held to
    # the reference in tests/test_torch_hcc_ext.py)
    moving = MixedTransientRDCSystem(mesh, 5, pihna_blocks, device="cpu",
                                     moving_mesh=True)
    assert moving.moving_mesh and not s.moving_mesh
    with pytest.raises(ValueError, match="coords"):
        moving.step(moving.initial_state(np.ones((mesh.n_nodes, 5))),
                    params=_pihna_params())
    cons = MixedTransientRDCSystem(mesh, 5, pihna_blocks, device="cpu",
                                   constraints=np.array([[0, 1, 2]])).cons
    assert cons.n_hanging == 1 and cons.hang.tolist() == [0]
    assert s.cons is None and MixedTransientRDCSystem(
        mesh, 5, pihna_blocks, device="cpu",
        constraints=np.zeros((0, 3), np.int32)).cons is None
    with pytest.raises(ValueError, match="MixedTransientRDCSystem"):
        TransientRDCSystem(mesh, 5, pihna_blocks, device="cpu")
    tet = mesh_from_reference(jax_box_tet_mesh(1, 1, 1))
    with pytest.raises(ValueError):
        MixedTransientRDCSystem(tet, 5, pihna_blocks, device="cpu")


def _driver_case(tmp_path, model, **kw):
    """make_*_case(n=3, n_steps=2, **kw) with an output and a checkpoint
    at every step and the linear tolerance 1e-14."""
    make = {"pihna": cases.make_pihna_case, "adpm": cases.make_adpm_case}
    d = make[model](str(tmp_path / model), n=3, n_steps=2, **kw)
    deck = open(os.path.join(d, "input.dat")).read()
    deck = deck.replace("output_step = 10", "output_step = 1").replace(
        "output_step = 20", "output_step = 1")
    # ADPM at the taxis-active amplitude: at the case deck's 1e3 the
    # full-dt f64 solve of the TET10 case does not converge (the driver,
    # as the reference's, does not subcycle)
    deck = deck.replace("0.999999e+3", "50.0")
    deck += "solver/linear/tolerance = 1e-14\ncheckpoint/step = 2\n"
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(deck)
    return d


def driver_against_reference(tmp_path, monkeypatch, model, system_cls,
                             **kw):
    """The port's driver on the small case; its checkpointed state
    against the case's system stepped twice directly, and its CSV rows and
    last VTU frame against the reference's writers on that state."""
    d = _driver_case(tmp_path, model, **kw)
    monkeypatch.chdir(d)
    run = {"pihna": dpihna.run, "adpm": dadpm.run}[model]
    out = run("input.dat", device="cpu")
    deck = Deck("input.dat")
    mesh = gmsh.read("Brain_Model.msh")
    ref_mesh = jgmsh.read("Brain_Model.msh")
    u0 = np.loadtxt("Brain_Model_Initial_Nodal_Field.dat")
    if model == "pihna":
        params = dpihna.load_params(deck)
        elem = np.loadtxt("Brain_Model_Initial_Elemental_Field.dat")
        blocks, fields, V = pihna_blocks, {}, 5
    else:
        params = dadpm.load_params(deck)
        elem = np.loadtxt("Brain_Model_Initial_Elemental_Field~symm.dat")
        blocks, V = adpm_blocks, 3
        fields = {"tracts": torch.as_tensor(elem)}
    sys_kw = {"precision": "mixed"} if mesh.elem_type == "MIXED" else {}
    s = system_cls(mesh, V, blocks, rtol=1e-14, device="cpu", **sys_kw)
    st = s.initial_state(u0)
    for t in (1, 2):
        sc = {"time": t * params["dt"]} if model == "adpm" else None
        st, _, res = s.step(st, fields=fields, params=params, scalars=sc)
        assert float(res) <= 1e-14
    ck = np.load(os.path.join(out, "checkpoint.npz"))
    u = st["u"].numpy()
    assert np.abs(ck["u"] - u).max() <= 1e-12 * np.abs(u).max()
    u = ck["u"]
    assert np.isfinite(u).all() and (u >= 0).all()
    # the CSV rows and the last VTU frame, from the reference's writers
    import io

    rows = open(os.path.join(out, "output.csv")).read().splitlines()
    buf = io.StringIO()
    if model == "pihna":
        ranges = dpihna.load_ranges(deck)
        jcsv.pihna_row(buf, ref_mesh, u, 2 * params["dt"],
                       {**params, **ranges})
        names = ("n", "c", "h", "v", "a")
        extra = [("HU", jvtu.elemental_to_nodal(ref_mesh, elem[:, 0])),
                 ("RT", jvtu.elemental_to_nodal(ref_mesh, elem[:, 1]))]
        base = "Brain_Model"
    else:
        ranges = {"range_A_b_min": 1e-12, "range_A_b_max": 1e12,
                  "range_Tau_min": 1e-12, "range_Tau_max": 1e12}
        # the JxW-integrated (A_b, Tau) per element, in NumPy from the
        # reference's element tables, block by block
        avg = []
        blocks_ = (ref_mesh.blocks if ref_mesh.elem_type == "MIXED"
                   else [ref_mesh])
        for b in blocks_:
            phi, dN, w = jel.tabulate(b.elem_type)
            X = ref_mesh.coords[b.connectivity]
            J = np.einsum("ekd,qkr->eqdr", X, dN)
            JxW = np.linalg.det(J) * w
            u_qp = np.einsum("qk,ekv->eqv", phi, u[b.connectivity])
            avg.append(np.einsum("eqv,eq->ev", u_qp[..., 1:3], JxW))
        jcsv.adpm_row(buf, ref_mesh, u, 2 * params["dt"], ranges,
                      np.concatenate(avg))
        names = ("PrP", "A_b", "Tau")
        extra = [(f"Tract{c}", jvtu.elemental_to_nodal(ref_mesh, elem[:, i]))
                 for i, c in enumerate("XYZ")]
        base = "Brain_Model"
    assert rows[-1] == buf.getvalue().strip()
    assert len(rows) == 4  # the header and steps 0, 1, 2
    fields = [(nm, u[:, i]) for i, nm in enumerate(names)] + extra
    jvtu.write_vtu(str(tmp_path / "ref.vtu"), ref_mesh, fields)
    assert (open(os.path.join(out, f"{base}-2.vtu")).read()
            == (tmp_path / "ref.vtu").read_text())
    with open(os.path.join(out, "Brain_Model~processed.msh")) as f:
        assert f.read() == jgmsh.dumps(ref_mesh)


@pytest.mark.parametrize("model", ["pihna", "adpm"])
def test_mixed_drivers_run(model, tmp_path, monkeypatch, capsys):
    driver_against_reference(tmp_path, monkeypatch, model,
                             MixedTransientRDCSystem, mixed=True)
    assert "elem_type=MIXED (" in capsys.readouterr().out


def test_mixed_pihna_amr_deck_raises(tmp_path, monkeypatch, capsys):
    """An AMR deck on the MIXED case, which raised until AMR on MIXED
    meshes was ported, adapts the mesh after step 1 and runs on
    (tests/test_torch_adapt_ext.py holds the step to the reference)."""
    d = _driver_case(tmp_path, "pihna", mixed=True)
    path = os.path.join(d, "input.dat")
    deck = open(path).read()
    with open(path, "w") as f:
        f.write(deck.replace("refinement_step = 10000",
                             "refinement_step = 1"))
    monkeypatch.chdir(d)
    out = dpihna.run("input.dat", device="cpu")
    text = capsys.readouterr().out
    assert "AMR step 1: adapted to " in text
    assert text.count(" ==== Step") == 2
    u = np.load(os.path.join(out, "checkpoint.npz"))["u"]
    assert np.isfinite(u).all() and (u >= 0).all()


if __name__ == "__main__":
    # the per-species readings behind test_mixed_step_matches_dense_solve's
    # bars: the port's step and the reference's own (its mixed step
    # program, compiled under quick_compile as these tests compile)
    for model in ("pihna", "adpm"):
        (ref_mesh, mesh, p, u0, jfields, fields, phys, blocks,
         u_ref) = _step_case(model)
        V = u0.shape[1]
        for precision, rtol in (("f64", 1e-14), ("mixed", 1e-12)):
            s = MixedTransientRDCSystem(mesh, V, blocks, precision=precision,
                                        rtol=rtol, device="cpu")
            st, _, _ = s.step(s.initial_state(u0), fields=fields, params=p)
            with quick_compile():
                js = JaxMixed(ref_mesh, V, phys, precision=precision,
                              rtol=rtol)
                jst, _, _ = js.step(js.initial_state(u0), fields=jfields,
                                    params=p)
            for who, u in (("port", st["u_raw"].numpy()),
                           ("reference", np.asarray(jst["u_raw"]))):
                print(model, precision, who, "per species",
                      " ".join(f"{e:.2e}" for e in _species_errors(u, u_ref)),
                      f"relative L2 {rel_l2(u, u_ref):.2e}", flush=True)
