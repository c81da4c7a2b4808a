"""The port's second-order TET10 meshes against rdcfes_tpu on the same
seeded NumPy inputs (np.random.default_rng(0)).

* the TET10 element tables equal to the reference's (within 1e-15),
  geometry_factors within 1e-13 relative on curved (jittered) elements;
* tet4_to_tet10(box_tet_mesh(3,3,3)) arrays equal, the Gmsh write
  byte-equal to the reference's `dumps` and the read round-trip, a TET10
  VTU frame (VTK's node order) and a PIHNA CSV row byte-equal;
* the plain K6 and K8 at (10, 14) within 1e-13 of the reference's
  qp_apply and interpolate_ue;
* one TET10 PIHNA step against the reference's element-matrix scipy
  assembly (the recipe of tests/test_tet10.py:112-160): f64 at rtol 1e-14
  within 1e-10 relative L2, and at the reference test's own settings
  (mixed, its default rtol 1e-12) within its 1e-8 per species;
* the PIHNA and ADPM drivers on make_*_case(n=3, n_steps=2, order=2) at
  solver/linear/tolerance 1e-14, held as in tests/test_torch_mixed.py;
  an AMR deck on TET10 adapts the mesh and runs on.

`python -m tests.test_torch_tet10 N STEPS` steps the TET10 PIHNA case
make_pihna_case(N, order=2) through both packages' driver systems and
prints each step's iterations, residual and largest v (at N = 20 both
run away from step 21; minutes a step, so not a test).
"""

import io
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import elements as jel
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.io import csv_metrics as jcsv
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.mesh import tet4_to_tet10 as jax_tet4_to_tet10
from rdcfes_tpu.models.pihna import pihna_physics

from rdcfes_tpu_torch.drivers import pihna as dpihna
from rdcfes_tpu_torch.fem import elements, geometry, kernels
from rdcfes_tpu_torch.io import csv_metrics, vtu
from rdcfes_tpu_torch.mesh import box_tet_mesh, gmsh, tet4_to_tet10
from rdcfes_tpu_torch.models.pihna import pihna_blocks
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.utils.convert import (blocks_from_numpy,
                                            mesh_from_reference)

from tests.test_torch_mixed import (_dense_solve, _driver_case,
                                    _per_species, _pihna_params,
                                    driver_against_reference, rel)
from tests.torch_helpers import quick_compile, rel_l2

B30 = ((0, 30.0),) * 3


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def test_element_tables_match():
    pts, wts = jel.quadrature("TET10")
    tp, tw = elements.quadrature("TET10")
    assert tp.shape == (14, 3)
    assert np.abs(tp - pts).max() <= 1e-15 and np.abs(tw - wts).max() <= 1e-15
    P = np.random.default_rng(0).uniform(0.05, 0.25, (7, 3))
    for fn in ("shape_functions", "shape_gradients"):
        a = getattr(elements, fn)("TET10", P)
        b = getattr(jel, fn)("TET10", P)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-15
    for a, b in zip(elements.tabulate("TET10"), jel.tabulate("TET10")):
        assert np.abs(a - b).max() <= 1e-15


_GEOMETRY = []


def _curved():
    """(coords, conn, phi, JxW, dphi) of jittered (curved) TET10, the
    geometry from the reference (computed once)."""
    if not _GEOMETRY:
        m = jax_tet4_to_tet10(jax_box_tet_mesh(3, 2, 2))
        rng = np.random.default_rng(0)
        coords = m.coords + 0.02 * rng.standard_normal(m.coords.shape)
        _GEOMETRY.extend((coords, m.connectivity) + jgeo.geometry_factors(
            jnp.asarray(coords), jnp.asarray(m.connectivity), "TET10"))
    return _GEOMETRY


def test_geometry_factors_match():
    coords, conn, phi, JxW, dphi = _curved()
    tphi, tJxW, tdphi = geometry.geometry_factors(
        torch.as_tensor(coords), torch.as_tensor(conn), "TET10")
    assert np.array_equal(tphi, phi) and tdphi.shape == (14, 10, 3,
                                                         conn.shape[0])
    assert rel(tJxW, JxW) <= 1e-13 and rel(tdphi, dphi) <= 1e-13


def test_tet4_to_tet10_and_io_match(tmp_path):
    a = jax_tet4_to_tet10(jax_box_tet_mesh(3, 3, 3))
    b = tet4_to_tet10(box_tet_mesh(3, 3, 3))
    for name in ("coords", "connectivity", "subdomain_id", "boundary_faces",
                 "boundary_elem", "boundary_side", "boundary_id"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert np.array_equal(a.element_volumes(), b.element_volumes())
    assert np.isclose(b.element_volumes().sum(), 1.0)
    with pytest.raises(ValueError):
        tet4_to_tet10(b)
    text = jgmsh.dumps(a)
    assert gmsh.dumps(b) == text
    path = str(tmp_path / "t10.msh")
    with open(path, "w") as f:
        f.write(text)
    for m in (gmsh.read(path), gmsh.read_numpy(io.StringIO(text))):
        assert m.elem_type == "TET10" and gmsh.dumps(m) == text
        assert np.array_equal(m.boundary_id, a.boundary_id)
    rng = np.random.default_rng(0)
    u = rng.random((b.n_nodes, 5)) * 2e3
    s = rng.random(b.n_elems)
    fields = [("n", u[:, 0]), ("S", vtu.elemental_to_nodal(b, s))]
    jvtu.write_vtu(str(tmp_path / "a.vtu"), a,
                   [("n", u[:, 0]), ("S", jvtu.elemental_to_nodal(a, s))])
    vtu.write_vtu(str(tmp_path / "b.vtu"), b, fields)
    assert (tmp_path / "a.vtu").read_text() == (tmp_path / "b.vtu").read_text()
    p = {"cells_max_capacity": 2.39e5}
    for k in ("active_tumor", "necrotic", "vascularity", "total_cell"):
        p[f"range_{k}_min"], p[f"range_{k}_max"] = 500.0, 1e12
    p["range_total_cell_min"] = 1e-3
    x, y = io.StringIO(), io.StringIO()
    jcsv.pihna_row(x, a, u, 1.5, p)
    csv_metrics.pihna_row(y, b, u, 1.5, p)
    assert x.getvalue() == y.getvalue()


def test_plain_kernels_match_reference():
    """apply_generic_plain and gather_interp_generic_plain at TET10's
    (10, 14) against the reference's interpolate_ue + qp_apply."""
    coords, conn, phi, JxW, dphi = _curved()
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
    st = kernels.stack_apply_generic(blocks_from_numpy(
        [rng.standard_normal((Q, E))] * V, [0.0] * V, C, D, Ee, "cpu"))
    tJxW, tdphi, tx = (torch.as_tensor(np.array(a)) for a in (JxW, dphi, x))
    Ye = kernels.apply_generic(tx, conn_T, phi, tJxW, tdphi, st)
    assert Ye.shape == (V, 10, E) and rel(Ye, ref) <= 1e-13
    out = kernels.gather_interp_generic(tx, conn_T, phi, tdphi)
    assert rel(out[0], x_qp) <= 1e-13 and rel(out[1], gx) <= 1e-13


def test_tet10_step_matches_scipy_assembly():
    """One PIHNA step on tet4_to_tet10(box_tet_mesh(3,3,3)) (0-30 mm)
    against the equilibrated dense solve of the reference's element
    matrices assembled with scipy."""
    ref_mesh = jax_tet4_to_tet10(jax_box_tet_mesh(3, 3, 3, bounds=B30))
    mesh = mesh_from_reference(ref_mesh)
    p = _pihna_params()
    N, V = mesh.n_nodes, 5
    u0 = np.abs(np.random.default_rng(0).random((N, V))) * np.array(
        [1., 100., 50., 500., 1e-10])
    phi, JxW, dphi = jgeo.geometry_factors(
        jnp.asarray(ref_mesh.coords), jnp.asarray(ref_mesh.connectivity),
        "TET10")
    u_qp, grad_qp = jasm.interpolate_at_qp(
        jnp.asarray(u0.T), jnp.asarray(ref_mesh.connectivity.T), phi, dphi)
    wf = pihna_physics(u_qp, grad_qp, {}, p)
    Ke = np.asarray(jwf.element_matrices(wf, phi, JxW, dphi))
    Fe = np.asarray(jwf.element_vectors(wf, phi, JxW, dphi))
    conn = ref_mesh.connectivity
    K = conn.shape[1]
    rows = np.repeat(conn, K, axis=1).reshape(-1)
    cols = np.tile(conn, (1, K)).reshape(-1)
    A = sps.bmat([[sps.csr_matrix(
        (Ke[v, w].transpose(2, 0, 1).reshape(-1), (rows, cols)),
        shape=(N, N)) for w in range(V)] for v in range(V)], format="csr")
    b = np.zeros((V, N))
    for v in range(V):
        np.add.at(b[v], conn.reshape(-1), Fe[v].T.reshape(-1))
    u_ref = _dense_solve(A, b.reshape(-1), u0)
    for precision, rtol, bar in (("f64", 1e-14, 1e-10),
                                 ("mixed", 1e-12, 1e-8)):
        s = TransientRDCSystem(mesh, V, pihna_blocks, precision=precision,
                               rtol=rtol, device="cpu")
        st, _, res = s.step(s.initial_state(u0), params=p)
        assert float(res) <= rtol
        u = st["u_raw"].numpy()
        err = (rel_l2(u, u_ref) if precision == "f64"
               else _per_species(u, u_ref))
        assert err <= bar, (precision, err)


@pytest.mark.parametrize("model", ["pihna", "adpm"])
def test_tet10_drivers_run(model, tmp_path, monkeypatch, capsys):
    driver_against_reference(tmp_path, monkeypatch, model,
                             TransientRDCSystem, order=2)
    assert "elem_type=TET10" in capsys.readouterr().out


def test_tet10_pihna_amr_deck_raises(tmp_path, monkeypatch, capsys):
    """An AMR deck on the TET10 case, which raised until AMR on TET10
    meshes was ported, adapts the mesh after step 1 and runs on
    (tests/test_torch_adapt_ext.py holds the step to the reference)."""
    d = _driver_case(tmp_path, "pihna", order=2)
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


def pihna_tet10_trajectory(package: str, n: int, steps: int, directory: str):
    """The TET10 PIHNA case, make_pihna_case(n, order=2), stepped by one
    package's driver system (make_rdc_system on the case's deck: f64
    BiCGStab, rtol 3e-11) until `steps` or the first failed solve.
    Returns one (inner iterations, residual, largest v) per step.  Not a
    test: the reference's TET10 step program takes minutes to compile
    and minutes a step at n = 20, where the case runs away; run it as
    `python -m tests.test_torch_tet10 N STEPS`."""
    if package == "reference":
        from rdcfes_tpu import cases as pkg_cases
        from rdcfes_tpu.drivers import pihna as pkg_pihna
        from rdcfes_tpu.drivers.common import make_rdc_system
        from rdcfes_tpu.io.getpot import Deck as PkgDeck
        from rdcfes_tpu.mesh import gmsh as pkg_gmsh
        from rdcfes_tpu.models.pihna import pihna_blocks as ref_blocks

        def make(mesh, deck):
            return make_rdc_system(mesh, 5, pihna_physics, deck,
                                   physics_blocks=ref_blocks)[0]
    else:
        from rdcfes_tpu_torch import cases as pkg_cases
        from rdcfes_tpu_torch.drivers import pihna as pkg_pihna
        from rdcfes_tpu_torch.drivers.common import make_rdc_system
        from rdcfes_tpu_torch.io.getpot import Deck as PkgDeck
        from rdcfes_tpu_torch.mesh import gmsh as pkg_gmsh

        def make(mesh, deck):
            return make_rdc_system(mesh, 5, pihna_blocks, deck,
                                   device="cpu")
    d = pkg_cases.make_pihna_case(directory, n=n, n_steps=steps, order=2)
    deck = PkgDeck(os.path.join(d, "input.dat"))
    mesh = pkg_gmsh.read(os.path.join(d, "Brain_Model.msh"))
    params = pkg_pihna.load_params(deck)
    u0 = np.loadtxt(os.path.join(d, "Brain_Model_Initial_Nodal_Field.dat"))
    system = make(mesh, deck)
    state, rows = system.initial_state(u0), []
    for _ in range(steps):
        state, it, res = system.step(state, params=params)
        rows.append((int(it), float(res),
                     float(np.asarray(state["u"])[:, 3].max())))
        if not rows[-1][1] <= system.rtol or rows[-1][0] >= system.maxiter:
            break
    return rows


if __name__ == "__main__":
    import sys
    import tempfile

    n, steps = int(sys.argv[1]), int(sys.argv[2])
    packages = sys.argv[3:] or ["reference", "port"]
    with tempfile.TemporaryDirectory() as tmp:
        for pkg in packages:
            rows = pihna_tet10_trajectory(pkg, n, steps,
                                          os.path.join(tmp, pkg))
            print(f"{pkg} n={n} step:iterations:residual:largest_v",
                  " ".join(f"{k + 1}:{it}:{res:.2e}:{v:.4e}"
                           for k, (it, res, v) in enumerate(rows)),
                  flush=True)
