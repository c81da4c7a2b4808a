"""The port's PROTEAS and RIPF drivers and its ExodusII export on mixed
(HEX8 + PYRAMID5 + TET4) and second-order TET10 meshes, against
rdcfes_tpu on the same seeded inputs.

* ExodusII: the files of box_mixed_mesh(4,2,2) (three element blocks)
  and of tet4_to_tet10(box_tet_mesh(2,2,2)) (one TETRA10 block) equal to
  the reference writer's in every dimension, variable and attribute but
  the title (tests/test_mixed.py:265, tests/test_tet10.py:343), and so
  are those that both packages' process_mesh drivers export from the
  meshes' Gmsh files (the port's no longer prints a NOTE);
* PROTEAS's dose and RIPF's rebuilt fields at the quadrature points, one
  entry per block on a MixedMesh, equal to the reference drivers'
  recipes (rdcfes_tpu/drivers/proteas.py:116-136, ripf.py:178-200)
  within 1e-13;
* the RIPF driver on make_ripf_case(n=3, mixed=True) held to the
  reference's driver at solver/linear/tolerance 1e-14 (the watch-list
  rule), as tests/test_torch_drivers_rt.py holds it on TET4: inputs
  byte-equal, species within 1e-10 relative L2 per field and frame, CSV
  rows within 1e-10, the time derivatives within 1e-8 of their largest
  value or within the round-off of a difference of two states over dt
  (1e-12 of the species' largest value / dt: HU does not move in the
  case's deck, so its derivative is that round-off in both packages);
* PROTEAS on the mixed and the TET10 case, RIPF on the TET10 case: the
  driver's first step held to the reference's step with the fields and
  params that the reference's driver builds, assembled eagerly (its
  MixedTransientRDCSystem.assemble_scipy on the mixed case, its element
  matrices on TET10) and solved densely; the same step of the port's
  system as an extra check; the last VTU frame equal to the reference
  writer's, RIPF's CSV rows to the reference's writer.  Their reference
  drivers are not run: the reference's mixed PROTEAS step program takes
  23 s to compile, its TET10 ones minutes.

The reference's programs compile under quick_compile."""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from rdcfes_tpu.drivers import process_mesh as jprocess
from rdcfes_tpu.drivers import proteas as jproteas
from rdcfes_tpu.drivers import ripf as jripf
from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.fem.elements import tabulate as jtabulate
from rdcfes_tpu.io import csv_metrics as jcsv
from rdcfes_tpu.io import exodus as jexodus
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.io.getpot import Deck as JDeck
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.mesh import tet4_to_tet10 as jax_tet4_to_tet10
from rdcfes_tpu.models.proteas import proteas_physics
from rdcfes_tpu.models.ripf import ripf_physics
from rdcfes_tpu.models.ripf import rt_dose_schedule as jrt_dose_schedule
from rdcfes_tpu.systems import MixedTransientRDCSystem as JaxMixed

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import process_mesh, proteas, ripf
from rdcfes_tpu_torch.drivers.common import make_rdc_system
from rdcfes_tpu_torch.io import exodus, vtu
from rdcfes_tpu_torch.io.getpot import Deck
from rdcfes_tpu_torch.mesh import gmsh
from rdcfes_tpu_torch.models.proteas import proteas_blocks
from rdcfes_tpu_torch.models.ripf import ripf_blocks
from rdcfes_tpu_torch.utils.convert import mesh_from_reference

from tests.test_torch_drivers import (_check_files, _check_species, _run,
                                      _summary_lines, _warnings)
from tests.test_torch_drivers_rt import RIPF_SPECIES, RIPF_TD
from tests.test_torch_mixed import _dense_solve, _per_species
from tests.test_torch_process_mesh import _drive, _netcdf
from tests.torch_helpers import quick_compile, rel_l2

MESHES = {"mixed": lambda: jax_box_mixed_mesh(4, 2, 2),
          "tet10": lambda: jax_tet4_to_tet10(jax_box_tet_mesh(2, 2, 2))}
KIND = {"mixed": {"mixed": True}, "tet10": {"order": 2}}


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


@pytest.mark.parametrize("kind", ["mixed", "tet10"])
def test_exodus_matches_reference(kind, tmp_path):
    """One block per element type (TETRA4, HEX8, PYRAMID5 on the mixed
    box), one TETRA10 block on TET10: every dimension, variable and
    attribute equal to the reference writer's."""
    from scipy.io import netcdf_file

    jm = MESHES[kind]()
    a, b = str(tmp_path / "ref.ex2"), str(tmp_path / "port.ex2")
    jexodus.write_exodus(a, jm)
    exodus.write_exodus(b, mesh_from_reference(jm))
    with netcdf_file(a, "r", mmap=False) as fa, \
            netcdf_file(b, "r", mmap=False) as fb:
        assert fa.dimensions == fb.dimensions
        assert list(fa.variables) == list(fb.variables)
        for name, va in fa.variables.items():
            vb = fb.variables[name]
            assert va.dimensions == vb.dimensions, name
            assert np.array_equal(va.data, vb.data), name
            assert va._attributes == vb._attributes, name
        ga = {k: v for k, v in fa._attributes.items() if k != "title"}
        gb = {k: v for k, v in fb._attributes.items() if k != "title"}
        assert ga.keys() == gb.keys()
        for k in ga:
            assert np.array_equal(ga[k], gb[k]), k
        types = [fb.variables[f"connect{i + 1}"].elem_type
                 for i in range(fb.dimensions["num_el_blk"])]
    blocks = jm.blocks if kind == "mixed" else [jm]
    want = {"TET4": b"TETRA4", "HEX8": b"HEX8", "PYRAMID5": b"PYRAMID5",
            "TET10": b"TETRA10"}
    assert types == [want[x.elem_type] for x in blocks]


@pytest.mark.parametrize("kind", ["mixed", "tet10"])
def test_process_mesh_exports_mixed_and_tet10(kind, tmp_path, monkeypatch,
                                              capsys):
    """process_mesh on a mixed and a TET10 Gmsh file, both drivers fed the
    same answers: the port exports (no NOTE), and its `.ex2` equals the
    reference's on re-read but the title."""
    jm = MESHES[kind]()
    outs = {}
    for name, run in (("ref", jprocess.run), ("port", process_mesh.run)):
        d = tmp_path / name
        d.mkdir()
        jgmsh.write(jm, str(d / "in.msh"))
        outs[name] = _drive(run, d, monkeypatch, capsys)
    assert "NOTE" not in outs["port"].err
    assert outs["port"].out == outs["ref"].out
    dims, var, attrs = _netcdf(str(tmp_path / "port" / "out.ex2"))
    rdims, rvar, rattrs = _netcdf(str(tmp_path / "ref" / "out.ex2"))
    assert dims == rdims and attrs == rattrs and list(var) == list(rvar)
    for k, (shape, arr, at) in var.items():
        assert shape == rvar[k][0] and at == rvar[k][2], k
        assert np.array_equal(arr, rvar[k][1]), k
    assert dims["num_el_blk"] == (3 if kind == "mixed" else 1)


def _qp_reference(jm, nodal):
    """The reference RIPF driver's qp_fields recipe
    (rdcfes_tpu/drivers/ripf.py:139-147, :178-200), eagerly, per block."""
    coords = jnp.asarray(jm.coords)
    blocks = jm.blocks if jm.elem_type == "MIXED" else [jm]
    out = []
    for b in blocks:
        phi, _, dphi = jgeo.geometry_factors(
            coords, jnp.asarray(b.connectivity), b.elem_type)
        vals, grads = jasm.interpolate_at_qp(
            jnp.asarray(nodal), jnp.asarray(b.connectivity.T), phi, dphi)
        g = grads[2]
        norm = jnp.linalg.norm(g, axis=-2, keepdims=True)
        unit = jnp.where(norm > 0.0, g / jnp.where(norm == 0, 1.0, norm),
                         0.0)
        out.append({"cc_dtime": vals[0], "fb_dtime": vals[1],
                    "RT": vals[2], "RT_grad_unit": unit})
    return out


@pytest.mark.parametrize("kind", ["mixed", "tet10"])
def test_fields_per_block_match_reference(kind):
    """rtd_at_qp (both samplings) and qp_fields, one entry per block on
    the mixed box, within 1e-13 of the reference drivers' recipes; on the
    TET4 block the unit gradient is one per element, expanded over Q,
    and a zero gradient gives a zero unit vector."""
    jm = MESHES[kind]()
    mesh = mesh_from_reference(jm)
    rng = np.random.default_rng(0)
    aux = np.stack([rng.uniform(20, 80, mesh.n_nodes),
                    rng.uniform(0, 60, mesh.n_nodes)], axis=1)
    blocks = jm.blocks if kind == "mixed" else [jm]
    for sampling in ("full", "reference"):
        got = proteas.rtd_at_qp(mesh, aux, sampling)
        assert isinstance(got, tuple) == (kind == "mixed")
        got = got if kind == "mixed" else (got,)
        for g, b in zip(got, blocks):
            phi = jtabulate(b.elem_type)[0]
            conn = b.connectivity
            want = (phi[:, 1][:, None] * aux[conn[:, 1], 0][None, :]
                    if sampling == "reference"
                    else np.einsum("qk,ek->qe", phi, aux[conn, 1]))
            assert g.shape == want.shape
            assert np.abs(g - want).max() <= 1e-13 * np.abs(want).max()

    nodal = rng.standard_normal((3, mesh.n_nodes))
    # a dose flat over x >= 0.5: zero gradients, zero unit vectors there
    x = mesh.coords[:, 0]
    nodal[2] = 7.0 + np.where(x < 0.5, rng.random(mesh.n_nodes), 0.0)
    system = make_rdc_system(mesh, 3, ripf_blocks, Deck({}), device="cpu")
    got = ripf.qp_fields(system, torch.as_tensor(nodal))
    want = _qp_reference(jm, nodal)
    for key in ("cc_dtime", "fb_dtime", "RT", "RT_grad_unit"):
        entries = got[key] if kind == "mixed" else (got[key],)
        assert isinstance(got[key], tuple) == (kind == "mixed")
        assert len(entries) == len(want)
        for e, w in zip(entries, want):
            w = np.asarray(w[key])
            assert tuple(e.shape) == w.shape, key
            assert np.abs(e.numpy() - w).max() <= 1e-13 * max(
                np.abs(w).max(), 1.0), key
    units = got["RT_grad_unit"] if kind == "mixed" else (
        got["RT_grad_unit"],)
    assert any((u.numpy() == 0.0).all(axis=1).any() for u in units)


def _case(d, driver, n_steps, tol=1e-14, **kw):
    """make_*_case(n=3) with the linear tolerance `tol`; RIPF at dt 0.5
    (two steps cross day 1 exactly) with an output every step."""
    make = {"proteas": cases.make_proteas_case,
            "ripf": cases.make_ripf_case}[driver]
    make(d, n=3, n_steps=n_steps, **kw)
    path = os.path.join(d, "input.dat")
    deck = open(path).read()
    if driver == "ripf":
        deck = deck.replace("output_time_points = ' 10 30 60 90 120 '",
                            "output_time_points = ' 1 2 '").replace(
            "time_step = 0.1", "time_step = 0.5")
    with open(path, "w") as f:
        f.write(deck + f"solver/linear/tolerance = {tol}\n")


def _ripf_files():
    return ["Lung_Model~processed.msh", "input.dat",
            "Lung_Model_Initial_Nodal_Field.dat",
            "Lung_Model_Initial_Nodal_Field~RT.dat", "Lung_Model.pvd"]


@pytest.fixture(scope="module")
def mixed_ripf_runs(tmp_path_factory):
    """(reference run, port run) of two RIPF steps on make_ripf_case(n=3,
    mixed=True)."""
    dirs = [str(tmp_path_factory.mktemp(f"ripf_{t}"))
            for t in ("ref", "port")]
    for d in dirs:
        _case(d, "ripf", 2, mixed=True)
    ref = _run(dirs[0], lambda: jripf.run("input.dat"), jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: ripf.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    return ref, port


def test_mixed_ripf_driver_matches_reference(mixed_ripf_runs):
    """Inputs byte-equal (the RT doses in every VTU), CSV rows within
    1e-10, species within 1e-10 relative L2 per field and frame, the time
    derivatives as the module docstring says, the doses equal; banners,
    the mesh summary and the warnings line-equal."""
    ref, port = mixed_ripf_runs
    names = _check_files(ref, port, [
        "Lung_Model~processed.msh", "input.dat",
        "Lung_Model_Initial_Nodal_Field.dat",
        "Lung_Model_Initial_Nodal_Field~RT.dat", "Lung_Model.pvd"])
    assert [f"Lung_Model-{t}.vtu" in names for t in range(3)] == [True] * 3
    a = open(os.path.join(ref.out, "output.csv")).read().splitlines()
    b = open(os.path.join(port.out, "output.csv")).read().splitlines()
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.array(y.split(","), dtype=float),
                                   np.array(x.split(","), dtype=float),
                                   rtol=1e-10, atol=0)
    _check_species(ref, port, RIPF_SPECIES)
    for (t, fa, _), (_, fb, _) in zip(ref.frames, port.frames):
        for name, species in zip(RIPF_TD, RIPF_SPECIES):
            # HU does not move in this deck: its derivative is the
            # round-off of a difference of two states over dt
            tol = max(1e-8 * np.abs(fa[name]).max(),
                      1e-12 * np.abs(fa[species]).max() / 0.5)
            assert np.abs(fb[name] - fa[name]).max() <= tol, (t, name)
        for name in ("RT_dose/broad", "RT_dose/focus", "RT_dose/total"):
            assert np.array_equal(fa[name], fb[name]), name
    assert np.abs(port.frames[-1][1]["cc_TimeDeriv"]).max() > 0
    assert "elem_type=MIXED (" in port.stdout
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    assert _warnings(port.stderr) == _warnings(ref.stderr)


PROTEAS_SPECIES = ("hos", "tum", "nec", "vsc", "oed")


def _reference_step(jm, V, physics, fields, params, u0):
    """One linearized-CN step of the reference's physics from u0 (N, V),
    unclamped and solved densely (equilibrated): A and b from the
    reference's MixedTransientRDCSystem.assemble_scipy on a MixedMesh,
    else from its element matrices assembled eagerly with scipy (the
    recipe of tests/test_tet10.py:112-160)."""
    if jm.elem_type == "MIXED":
        A, b = JaxMixed(jm, V, physics).assemble_scipy(u0.T, fields, params)
        return _dense_solve(A, b, u0)
    N, conn = jm.n_nodes, jm.connectivity
    phi, JxW, dphi = jgeo.geometry_factors(
        jnp.asarray(jm.coords), jnp.asarray(conn), jm.elem_type)
    u_qp, grad_qp = jasm.interpolate_at_qp(
        jnp.asarray(u0.T), jnp.asarray(conn.T), phi, dphi)
    wf = physics(u_qp, grad_qp, fields, params)
    Ke = np.asarray(jwf.element_matrices(wf, phi, JxW, dphi))
    Fe = np.asarray(jwf.element_vectors(wf, phi, JxW, dphi))
    K = conn.shape[1]
    rows = np.repeat(conn, K, axis=1).reshape(-1)
    cols = np.tile(conn, (1, K)).reshape(-1)
    A = sps.bmat([[sps.csr_matrix(
        (Ke[v, w].transpose(2, 0, 1).reshape(-1), (rows, cols)),
        shape=(N, N)) for w in range(V)] for v in range(V)], format="csr")
    b = np.zeros((V, N))
    for v in range(V):
        np.add.at(b[v], conn.reshape(-1), Fe[v].T.reshape(-1))
    return _dense_solve(A, b.reshape(-1), u0)


@pytest.mark.parametrize("driver,kind", [("proteas", "mixed"),
                                         ("proteas", "tet10"),
                                         ("ripf", "tet10")])
def test_driver_first_step_matches_reference(driver, kind, tmp_path):
    """Two steps at solver/linear/tolerance 1e-14: the first held to the
    reference's step (_reference_step) with the fields and params that
    the reference's driver builds for step 1 (its deck reader, dose
    sampling per block, qp_fields recipe and dose schedule), clamped as
    the reference clamps, within 1e-10 of each species' largest value;
    and, as an extra check, equal (1e-12 relative) to the port's system
    stepped with the same fields.  The last VTU frame equal to the
    reference writer's on the same arrays (PROTEAS's nodal HU and RTD
    are the AUX file's); RIPF's CSV rows equal to the reference's writer
    on the frames; every frame finite."""
    d = str(tmp_path)
    _case(d, driver, 2, **KIND[kind])
    prun = {"proteas": proteas.run, "ripf": ripf.run}[driver]
    port = _run(d, lambda: prun("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    assert port.stdout.count(" ==== Step") == 2
    assert [f[0] for f in port.frames] == [0, 1, 2]
    path = os.path.join(d, "input.dat")
    deck, jdeck = Deck(path), JDeck(path)
    base = {"proteas": "Proteas_", "ripf": "Lung_"}[driver]
    msh = os.path.join(d, f"{base}Model.msh")
    mesh, jm = gmsh.read(msh), jgmsh.read(msh)
    per_block = (lambda xs: tuple(xs)) if kind == "mixed" else (
        lambda xs: xs[0])
    if driver == "proteas":
        u0 = np.loadtxt(os.path.join(d, "Proteas_Initial_Nodal_Field.dat"))
        aux = np.loadtxt(os.path.join(d, "Proteas_Aux_Nodal_Field.dat"))
        rtd = [np.einsum("qk,ek->qe", jtabulate(b.elem_type)[0],
                         aux[b.connectivity, 1])
               for b in (jm.blocks if kind == "mixed" else [jm])]
        jfields = {"RTD": per_block([jnp.asarray(r) for r in rtd])}
        fields = {"RTD": per_block([torch.as_tensor(r) for r in rtd])}
        jparams = jproteas.load_params(jdeck)
        params, blocks, physics, names = (proteas.load_params(deck),
                                          proteas_blocks, proteas_physics,
                                          PROTEAS_SPECIES)
        clamp, jclamp = {}, lambda u: np.maximum(u, 0.0)
    else:
        u0 = np.loadtxt(os.path.join(d, "Lung_Model_Initial_Nodal_Field.dat"))
        rt = np.loadtxt(os.path.join(d,
                                     "Lung_Model_Initial_Nodal_Field~RT.dat"))
        # step 1: zero time derivatives, the dose of day 0 and its
        # int-truncated maximum (rdcfes_tpu/drivers/ripf.py:153-166)
        dose = np.asarray(jrt_dose_schedule(
            rt[:, 0], rt[:, 1], 0.0, jdeck("RT_dose/broad/fractions", 1),
            jdeck("RT_dose/focus/fractions", 1)))
        q = _qp_reference(jm, np.stack([0 * dose, 0 * dose, dose]))
        lam = float(int(dose.max()))
        jfields = {k: per_block([w[k] for w in q]) for k in q[0]}
        jfields["lambda_RT_r"] = jfields["omicro_RT_r"] = lam
        fields = {k: per_block([torch.as_tensor(np.array(w[k])) for w in q])
                  for k in q[0]}
        fields["lambda_RT_r"] = fields["omicro_RT_r"] = lam
        jparams = {k: v for k, v in jripf.load_params(jdeck).items()
                   if not k.startswith("_") and k not in ripf._RESOLVED}
        params = {k: v for k, v in ripf.load_params(deck).items()
                  if not k.startswith("_") and k not in ripf._RESOLVED}
        blocks, physics, names = ripf_blocks, ripf_physics, RIPF_SPECIES
        clamp = {"clamp": lambda u: torch.cat(
            [torch.clamp(u[:1], -1000.0, 1000.0),
             torch.clamp(u[1:], min=0.0)])}
        jclamp = lambda u: np.concatenate(
            [np.clip(u[:, :1], -1000.0, 1000.0), np.maximum(u[:, 1:], 0.0)],
            axis=1)
    u1 = np.stack([port.frames[1][1][nm] for nm in names], axis=1)
    u_ref = jclamp(_reference_step(jm, len(names), physics, jfields,
                                   jparams, u0))
    # per-species bars (each species' largest error over its largest
    # value): 1e-10, but RIPF's the reference's 1e-8
    # (tests/test_mixed.py:183), since the Krylov stop measures all
    # species in one norm and RIPF's HU is ~1.6e4 times its fb.  The
    # readings: PROTEAS mixed <= 7.7e-15, TET10 <= 7.1e-14; RIPF TET10
    # (HU, cc, fb) 3.7e-15, 1.6e-10, 1.3e-9, which grow to 1.2e-8 for fb
    # at the solver tolerance 1e-12 and 1.1e-5 at 1e-10
    assert _per_species(u1, u_ref) <= {"proteas": 1e-10,
                                       "ripf": 1e-8}[driver]
    assert rel_l2(u1, u_ref) <= 1e-10
    s = make_rdc_system(mesh, len(names), blocks, deck, device="cpu",
                        **clamp)
    st, _, res = s.step(s.initial_state(u0), fields=fields, params=params)
    assert float(res) <= 1e-14
    want = st["u"].numpy()
    assert np.linalg.norm(u1 - want) <= 1e-12 * np.linalg.norm(want)
    for _, f, _ in port.frames:
        assert all(np.isfinite(v).all() for v in f.values())
    t, last, _ = port.frames[-1]
    if driver == "proteas":
        assert np.array_equal(last["HU"], aux[:, 0])
        assert np.array_equal(last["RTD"], aux[:, 1])
    ref_vtu = str(tmp_path / "ref.vtu")
    jvtu.write_vtu(ref_vtu, jm, list(last.items()))
    vtus = sorted(n for n in os.listdir(port.out) if n.endswith("-2.vtu"))
    assert len(vtus) == 1
    assert open(os.path.join(port.out, vtus[0])).read() == open(
        ref_vtu).read()
    if driver == "ripf":
        import io

        ranges = {"range_cc_HU_min": -1000.0, "range_cc_HU_max": 1000.0,
                  "range_cc_min": 1e-9, "range_fb_HU_min": -1000.0,
                  "range_fb_HU_max": 1000.0, "range_fb_min": 1e-9}
        rows = open(os.path.join(port.out, "output.csv")).read().splitlines()
        for (t, f, _), row in zip(port.frames, rows):
            buf = io.StringIO()
            u = np.stack([f[nm] for nm in names], axis=1)
            jcsv.ripf_row(buf, jm, u, 0.5 * t, ranges)
            assert row == buf.getvalue().strip(), t
