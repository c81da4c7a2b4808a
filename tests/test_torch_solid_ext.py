"""The port's solid on MIXED and TET10 meshes, its constrained Newton and
its remeshing, against rdcfes_tpu.

* TRI6 tables against the reference's (1e-15) and the TRI6 face
  geometry of a TET10 mesh's boundary (1e-13);
* build_sparsity_mixed equal to the reference's, array for array;
* SolidSystem.assemble on box_mixed_mesh(4, 2, 2) and
  tet4_to_tet10(box_tet_mesh(2, 2, 2)), fibres and growth active, against
  the reference's assemble at the same positions: f64 within 1e-13 of the
  largest entry, the f32 tangent within 1e-5 (the reference promotes its
  "f32" tangent back to f64, the port does not);
* run_solver on those meshes, one load step, against a dense Newton on
  the reference's own assembly (the reference's matrix-free run_solver
  would compile its linear stage again for each mesh): within 1e-9 of
  the displacement scale; post_process within 1e-10;
* the constrained Newton on the reference's refined mixed mesh with
  hanging nodes (tests/test_solid_constrained.py:31-40) against the
  reference's own acceptance solve there, the dense reduced Newton on
  the reference's assembly (tests/test_solid_constrained.py:43-84),
  within 1e-8 of the displacement scale, every hanging node on its
  masters' midpoint within 1e-12, and the mixed precision linear stage
  within 1e-5 of it;
* the solid driver with remeshing at load step 1 on MIXED, TET4, TET10
  and HEX8 meshes (the deck of tests/test_solid_constrained.py:114, with
  tight Newton tolerances): the refined mesh equals the reference's AMR
  (Kelly, flags, MixedConstrained / bisection / Tet10Adaptive / uniform
  1:8) applied to the port's load-step-1 fields, the last frame holds
  the refined mesh's cells and equals a SolidSystem on the reference's
  refined mesh, solved from the reference's prolongation of the
  positions, within 1e-12 (a reference driver run costs 24-27 s on the
  MIXED and TET10 meshes, so those drivers are held to the reference's
  pieces; the TET4 and HEX8 drivers, 11-13 s, are also held to the
  reference's driver in tests/test_torch_solid_remesh.py); and a run
  resumed from the checkpoint written after remeshing ends where the
  uninterrupted run ends.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import amr as jamr
from rdcfes_tpu.fem import elements as jel
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.fem.assembly import build_sparsity_mixed as jax_bsm
from rdcfes_tpu.mesh import adapt as jadapt
from rdcfes_tpu.mesh import adapt_ext as jadapt_ext
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.mesh import refine as jrefine
from rdcfes_tpu.mesh import tet4_to_tet10 as jax_tet4_to_tet10
from rdcfes_tpu.systems import solid as jsolid

from rdcfes_tpu_torch.drivers import common, solid as solid_driver
from rdcfes_tpu_torch.fem import assembly, elements, geometry
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.solvers.newton import NewtonOptions
from rdcfes_tpu_torch.systems import solid
from rdcfes_tpu_torch.utils.convert import mesh_from_reference

from tests.test_solid_constrained import (_dense_constrained_newton,
                                          _refined_mixed_with_constraints)
from tests.test_torch_drivers import _run
from tests.torch_helpers import quick_compile

BCS = {0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05),
       2: (0.01, np.nan, np.nan)}
TIGHT = dict(max_nonlinear_iterations=30, relative_residual_tolerance=1e-12,
             relative_step_tolerance=1e-13, absolute_residual_tolerance=1e-9)
MESHES = {
    "mixed": lambda: jax_box_mixed_mesh(4, 2, 2),
    "tet10": lambda: jax_tet4_to_tet10(jax_box_tet_mesh(2, 2, 2)),
}


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def rel(a, b):
    a = a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _deck(mesh, seed):
    """Materials with fibres and growth on two subdomains, seeded unit
    fibres per element and positions perturbed by 0.02."""
    rng = np.random.default_rng(seed)
    mats = {0: {"young": 1.0e3, "poisson": 0.3, "fibre_stiffness": 40.0,
                "stretch_rate_0": 0.1, "stretch_rate_2": -0.05},
            1: {"young": 2.0e3, "poisson": 0.35}}
    fib = rng.standard_normal((mesh.n_elems, 3))
    fib /= np.linalg.norm(fib, axis=1, keepdims=True)
    x = mesh.coords + 0.02 * rng.standard_normal(mesh.coords.shape)
    return dict(materials=mats, bcs=BCS, penalty=1.0e6, fibres=fib), x


def _with_two_subdomains(jm):
    """Subdomain 1 on the elements whose first node lies at x > 0.5."""
    blocks = jm.blocks if jm.elem_type == "MIXED" else [jm]
    for b in blocks:
        b.subdomain_id[:] = (jm.coords[b.connectivity[:, 0], 0]
                             > 0.5).astype(b.subdomain_id.dtype)
    return jm


def _dense_newton(assemble, x0, N, tol=1e-13, iters=30):
    """Newton with dense LU solves on an assembly (R (3, N), values
    (3, 3, nnz)) at channel-first positions."""
    x = np.array(x0, dtype=np.float64)
    r0 = None
    for _ in range(iters):
        R, values, rows, cols = assemble(x)
        rn = float(np.linalg.norm(R))
        r0 = r0 or rn
        if rn <= tol * r0:
            break
        A = np.zeros((3 * N, 3 * N))
        for v in range(3):
            for w in range(3):
                A[v * N + rows, w * N + cols] = values[v, w]
        x -= np.linalg.solve(A, R.reshape(-1)).reshape(3, N).T
    return x


@pytest.fixture(scope="module", params=list(MESHES))
def case(request):
    """Both packages' systems on one mesh, the reference's assembly at
    the perturbed positions (its jitted program, compiled once) and the
    reference's equilibrium by dense Newton on that program."""
    jm = _with_two_subdomains(MESHES[request.param]())
    kw, x = _deck(jm, 3)
    js = jsolid.SolidSystem(jm, **kw)
    pt = jnp.asarray(0.4)
    asm = lambda y: js._assemble_jit(jnp.asarray(
        np.ascontiguousarray(y.T)), pt)
    R, vals = asm(x)
    rows, cols = js.sp.rows, js.sp.cols
    xeq = _dense_newton(lambda y: tuple(map(np.asarray, asm(y)))
                        + (rows, cols), js.initial_positions(), jm.n_nodes)
    p, vm, fc = js.post_process(jnp.asarray(xeq), 0.4)
    pm = mesh_from_reference(jm)
    return dict(kind=request.param, jm=jm, pm=pm, kw=kw, x=x, R=R,
                vals=vals, xeq=xeq, post=(p, vm, fc), js=js)


def test_tri6_tables_and_face_geometry():
    for a, b in zip(elements.tabulate("TRI6"), jel.tabulate("TRI6")):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-15
    m = jax_tet4_to_tet10(jax_box_tet_mesh(2, 2, 2))
    rng = np.random.default_rng(2)
    x = m.coords + 0.02 * rng.standard_normal(m.coords.shape)
    ref = jgeo.face_geometry_factors(jnp.asarray(x),
                                     jnp.asarray(m.boundary_faces), "TRI6")
    out = geometry.face_geometry_factors(
        torch.as_tensor(x), torch.as_tensor(m.boundary_faces.astype(np.int64)),
        "TRI6")
    assert m.boundary_faces.shape[1] == 6
    for a, b in zip(out, ref):
        assert rel(a, b) <= 1e-13


def test_build_sparsity_mixed_equal():
    m = jax_box_mixed_mesh(4, 2, 2)
    sp, lists = assembly.build_sparsity_mixed(m.blocks, m.n_nodes)
    jsp, jlists = jax_bsm(m.blocks, m.n_nodes)
    assert sp.nnz == jsp.nnz and len(lists) == len(jlists) == 3
    for name in ("rows", "cols", "slots", "row_ptr", "diag_slots"):
        a, b = getattr(sp, name), getattr(jsp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(lists, jlists):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("tp,tol", [("f64", 1e-13), ("f32", 1e-5)])
def test_assemble_matches_reference(case, tp, tol):
    """One K4 gather over the concatenated blocks against the
    reference's block-by-block sums."""
    ts = solid.SolidSystem(case["pm"], device="cpu", tangent_precision=tp,
                           **case["kw"])
    xT = torch.as_tensor(np.ascontiguousarray(case["x"].T))
    R, vals = ts.assemble(xT, 0.4)
    assert rel(R, case["R"]) <= 1e-13
    assert rel(vals, case["vals"]) <= tol
    assert rel(ts.assemble_residual(xT, 0.4), case["R"]) <= 1e-13
    assert ts.node_gather.shape[1] == case["jm"].n_nodes
    if case["kind"] == "mixed":
        assert [g["face_type"] for g in ts.bc_groups] == ["QUAD4", "TRI3"]
    else:
        assert [g["face_type"] for g in ts.bc_groups] == ["TRI6"]


def test_run_solver_and_post_process_match_reference(case):
    ts = solid.SolidSystem(case["pm"], device="cpu",
                           newton=NewtonOptions(**TIGHT), **case["kw"])
    r = ts.run_solver(ts.initial_positions(), 0.4)
    assert r.converged
    X0, xeq = case["jm"].coords, case["xeq"]
    scale = np.abs(xeq - X0).max()
    assert np.abs(r.x.numpy() - xeq).max() / scale <= 1e-9
    for a, b in zip(ts.post_process(torch.as_tensor(xeq), 0.4),
                    case["post"]):
        assert rel(a, b) <= 1e-10


@pytest.fixture(scope="module")
def constrained():
    mesh, cons = _refined_mixed_with_constraints()
    kw = dict(materials={0: {"young": 1.0e3, "poisson": 0.3}}, bcs=BCS,
              penalty=1.0e6)
    js = jsolid.SolidSystem(mesh, constraints=cons, **kw)
    x, r = _dense_constrained_newton(js, mesh.coords, jnp.asarray(0.5), cons)
    assert r <= 1e-10
    return mesh, cons, kw, x


def _hanging_err(x, cons):
    h, a, b = cons[:, 0], cons[:, 1], cons[:, 2]
    return float(np.abs(x[h] - 0.5 * (x[a] + x[b])).max())


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_constrained_newton_matches_reference(constrained, precision):
    mesh, cons, kw, xr = constrained
    ts = solid.SolidSystem(mesh_from_reference(mesh), device="cpu",
                           constraints=cons, newton=NewtonOptions(
                               **TIGHT, linear_precision=precision), **kw)
    r = ts.run_solver(ts.initial_positions(), 0.5)
    assert r.converged
    x = r.x.numpy()
    scale = np.abs(xr - mesh.coords).max()
    assert _hanging_err(x, cons) <= 1e-12
    # the reference's f64 solve; the mixed stage within the bar of
    # tests/test_solid_constrained.py:226
    assert np.abs(x - xr).max() / scale <= (1e-8 if precision == "f64"
                                            else 1e-5)


# ----------------------------------------------------------------------
# the driver
# ----------------------------------------------------------------------
DRIVER_DECK = """
directory = simulation
input_GMSH = input.msh
output_PARAVIEW = out
loading_step = 0.5
output_time_points = ' 1 2 '
remeshing_step = 1
mesh/AMR/max_steps = 1
checkpoint/step = 1
solver/nonlinear/max_nonlinear_iterations = 20
solver/nonlinear/relative_step_tolerance = 1.e-13
solver/nonlinear/relative_residual_tolerance = 1.e-12
solver/nonlinear/absolute_residual_tolerance = 1.e-9
BCs = ' 0 5 '
BC/0/displacement/0 = +0.000
BC/0/displacement/1 = +0.000
BC/0/displacement/2 = +0.000
BC/5/displacement/0 = NAN
BC/5/displacement/1 = NAN
BC/5/displacement/2 = -0.10
BCs/displacement_penalty = 1.e+6
materials = ' 0 '
material/0/Hyperelastic/Young = 1.0e+4
material/0/Hyperelastic/Poisson = 0.3
"""
DRIVER_MESHES = {
    "mixed": lambda: jax_box_mixed_mesh(4, 2, 2, bounds=((0, 1.0),) * 3),
    "tet4": lambda: jax_box_tet_mesh(2, 2, 2),
    "tet10": lambda: jax_tet4_to_tet10(jax_box_tet_mesh(2, 2, 2)),
    "hex8": lambda: jax_box_hex_mesh(2, 2, 2),
}


def _reference_remesh(jm, ind):
    """The reference driver's remeshing pass on mesh jm with nodal
    indicators ind (N, 2): (mesh, prolong, constraints)."""
    if jm.elem_type == "MIXED":
        eta = jadapt_ext.kelly_mixed(jm, jnp.asarray(ind), [0, 1])
    else:
        eta = jamr.kelly_error_indicator(jm, jnp.asarray(ind), [0, 1])
    flags, coarsen = jamr.flag_by_mean_stddev(np.asarray(eta), 0.5, 0.5)
    if jm.elem_type == "MIXED":
        out = jadapt_ext.MixedConstrained.from_mesh(jm).refine_and_coarsen(
            flags, coarsen, max_level=3)
        return out.mesh, out.prolong, out.constraints
    if jm.elem_type == "TET4":
        r = jadapt.adapt_flagged(jadapt.AdaptiveMesh(jm), flags, coarsen,
                                 max_level=3)
    elif jm.elem_type == "TET10":
        r = jadapt_ext.Tet10Adaptive.from_mesh(jm).refine_and_coarsen(
            flags, coarsen, max_level=3)
    else:
        r = jrefine.refine_flagged(jm, flags)
    return r.mesh, r.prolong, np.zeros((0, 3), np.int64)


def _same_mesh(pm, jm):
    assert pm.elem_type == jm.elem_type
    assert np.array_equal(pm.coords, jm.coords)
    pb = pm.blocks if pm.elem_type == "MIXED" else [pm]
    jb = jm.blocks if jm.elem_type == "MIXED" else [jm]
    for a, b in zip(pb, jb, strict=True):
        assert np.array_equal(a.connectivity, b.connectivity)
    assert np.array_equal(pm.boundary_id, jm.boundary_id)


def _driver(d, extra=""):
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(DRIVER_DECK + extra)
    return _run(d, lambda: solid_driver.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)


@pytest.fixture
def recorded(monkeypatch):
    """Every remeshing pass (mesh, indicators, result) and every load
    step's Newton result of the drivers run under it."""
    rec = {"adapt": [], "newton": []}
    adapt, newton = common.Remesher.adapt, solid.SolidSystem.run_solver

    def adapt_(self, mesh, ind):
        rec["adapt"].append((mesh, ind, adapt(self, mesh, ind)))
        return rec["adapt"][-1][2]

    def newton_(self, x, pt):
        rec["newton"].append(newton(self, x, pt))
        return rec["newton"][-1]

    monkeypatch.setattr(common.Remesher, "adapt", adapt_)
    monkeypatch.setattr(solid.SolidSystem, "run_solver", newton_)
    return rec


@pytest.mark.parametrize("kind", list(DRIVER_MESHES))
def test_solid_driver_remeshing(kind, tmp_path, recorded):
    jm = DRIVER_MESHES[kind]()
    jgmsh.write(jm, str(tmp_path / "input.msh"))
    run = _driver(str(tmp_path))
    (m1, ind, r), = recorded["adapt"]
    x1 = recorded["newton"][0].x.numpy()  # load step 1, before remeshing
    rm, prolong, cons = _reference_remesh(jm, ind)
    _same_mesh(r.mesh, rm)
    assert np.array_equal(r.constraints, cons)
    assert (f"remeshing step 1: adapted to {rm.n_elems} elements"
            in run.stdout) and rm.n_elems > m1.n_elems
    # frames 0, 1, 2; frame 1 written after remeshing
    assert [f[0] for f in run.frames] == [0, 1, 2]
    scale = np.abs(x1).max()
    assert np.abs(run.frames[1][2] - prolong(x1)).max() <= 1e-15 * scale
    # load step 2: a SolidSystem on the reference's mesh, with its
    # hanging nodes, from the reference's prolongation of x1
    pm = mesh_from_reference(rm)
    s = solid_driver.make_solid(
        solid_driver.Deck(str(tmp_path / "input.dat")), pm,
        np.zeros((pm.n_elems, 3)), "cpu", cons if len(cons) else None)
    want = s.run_solver(torch.as_tensor(prolong(x1)), 1.0).x.numpy()
    xl = run.frames[2][2]
    assert np.abs(xl - want).max() <= 1e-12 * scale
    if len(cons):
        assert _hanging_err(xl, cons) <= 1e-12
    assert (kind == "mixed") == (len(cons) > 0)
    with open(tmp_path / "simulation" / "out-2.vtu") as f:
        cells = int(re.search(r'NumberOfCells="(\d+)"', f.read()).group(1))
    assert cells == rm.n_elems
    ck = solid_driver.gmsh.read(str(tmp_path / "simulation"
                                    / "checkpoint_mesh.msh"))
    assert ck.n_elems == rm.n_elems and ck.n_nodes == rm.n_nodes


def test_solid_driver_resumes_after_remeshing(tmp_path, monkeypatch):
    """The mixed run's checkpoint at load step 1, written after
    remeshing (the refined mesh beside it, the hanging nodes inside),
    resumed: the last frame equals the uninterrupted run's within
    1e-12."""
    jgmsh.write(DRIVER_MESHES["mixed"](), str(tmp_path / "input.msh"))
    keep = tmp_path / "ck"
    os.makedirs(keep)
    save = solid_driver.save_checkpoint

    def keep_step_1(path, state, step, *a, **kw):
        save(path, state, step, *a, **kw)
        if step == 1:
            for name in ("checkpoint.npz", "checkpoint_mesh.msh"):
                shutil.copy(os.path.join(os.path.dirname(path), name), keep)

    monkeypatch.setattr(solid_driver, "save_checkpoint", keep_step_1)
    full = _driver(str(tmp_path))
    ck = str(keep / "checkpoint.npz")
    with np.load(ck) as z:
        assert int(z["amr_done"]) == 1 and len(z["constraints"])
    resumed = _driver(str(tmp_path), f"checkpoint/resume = '{ck}'\n")
    assert "resumed on remeshed grid (" in resumed.stdout
    assert f"resumed from {ck} at load step 1" in resumed.stdout
    assert resumed.stdout.count(" ==== Step") == 1
    a, b = resumed.frames[-1][2], full.frames[-1][2]
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
