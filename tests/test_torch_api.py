"""The standalone public surface of rdcfes_tpu_torch held to rdcfes_tpu on
seeded NumPy inputs (the functions no driver reaches):

* fem.bcsr.bcsr_matvec and fem.assembly.assemble_matrix /
  assemble_vector (ordered gather-sums where the reference scatter-adds)
  within 1e-13 of the largest reference value; gather_tables exactly;
* solvers.krylov.solve_bcsr by BiCGStab, CG and GMRES: the reference's
  solution within 1e-9 relative (rtol 1e-12 on a well-conditioned SPD
  block system), both within 1e-9 of LAPACK;
* fem.weakform.block_element_matrices on the reference's PIHNA blocks
  (TET4 by both routes, HEX8 by the per-q one) within 1e-13, and equal
  to the port's element_matrices on the dense form within 1e-13;
* models.hyperelastic.kinematics / stress_and_tangent within 1e-13 and
  models.eig3.eigvalsh3 / eigh3 within 1e-12 (eigenvectors up to sign),
  and within 1e-8 of LAPACK (the closed form's accuracy);
* solvers.newton.newton_solve equal to NewtonSolver(sp, opts).solve;
  systems.solid.SolidBC's fields;
* utils.scalars: the angle conversions exactly, the random helpers by
  shape, range, moments and determinism under one torch.Generator (their
  streams cannot equal JAX's);
* every name each reference subpackage exports is importable from the
  port's, but the TPU-only ones listed in TPU_ONLY.
"""

import ast
import dataclasses
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import bcsr as jbcsr
from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.fem.geometry import geometry_factors as jgeometry
from rdcfes_tpu.mesh import box_hex_mesh as jbox_hex_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jbox_tet_mesh
from rdcfes_tpu.models import eig3 as jeig3
from rdcfes_tpu.models import hyperelastic as jhyper
from rdcfes_tpu.models.pihna import pihna_blocks as jpihna_blocks
from rdcfes_tpu.solvers import krylov as jkrylov
from rdcfes_tpu.systems.solid import SolidBC as JSolidBC
from rdcfes_tpu.utils import scalars as jscalars

from rdcfes_tpu_torch.fem import assembly, bcsr, weakform
from rdcfes_tpu_torch.fem.kernels import PLAIN_OPS
from rdcfes_tpu_torch.models import eig3, hyperelastic
from rdcfes_tpu_torch.models.pihna import default_params
from rdcfes_tpu_torch.solvers import krylov
from rdcfes_tpu_torch.solvers.newton import (NewtonOptions, NewtonSolver,
                                             newton_solve)
from rdcfes_tpu_torch.systems.solid import SolidBC
from rdcfes_tpu_torch.utils import scalars
from rdcfes_tpu_torch.utils.convert import blocks_from_numpy

from tests.torch_helpers import quick_compile

TOL = 1e-13
# names a reference subpackage exports that belong to the TPU alone: the
# x64 switch the reference flips at import, and the native library's
# Beneš edge-colouring hook (fem/benes.py's router; ROADMAP: not ported)
TPU_ONLY = {"": {"jax_enable_x64"},
            "native": {"_has_benes", "benes_color_batch"}}
SUBPACKAGES = ("", "fem", "solvers", "systems", "models", "io", "utils",
               "mesh", "drivers", "native", "parallel")


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """The reference's eager calls and while_loops compile what they meet;
    at these sizes that is their whole cost (tests/torch_helpers)."""
    with quick_compile():
        yield


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(a, ref) -> float:
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def sparse_case():
    """box_tet_mesh(3)'s node-pair sparsity (built by both packages) and
    seeded block values, element matrices and vectors."""
    mesh = jbox_tet_mesh(3, 3, 3)
    N, E, K = mesh.n_nodes, mesh.n_elems, mesh.nodes_per_elem
    sp = assembly.build_sparsity(mesh.connectivity, N)
    jsp = jasm.build_sparsity(mesh.connectivity, N)
    rng = np.random.default_rng(19)
    return dict(mesh=mesh, sp=sp, jsp=jsp, N=N,
                values=rng.standard_normal((2, 3, sp.nnz)),
                x=rng.standard_normal((3, N)),
                Ke=rng.standard_normal((2, 3, K, K, E)),
                Fe=rng.standard_normal((2, K, E)))


def test_gather_tables_match_reference(sparse_case):
    c = sparse_case
    for name in ("rows", "cols", "slots", "row_ptr", "diag_slots"):
        np.testing.assert_array_equal(getattr(c["sp"], name),
                                      getattr(c["jsp"], name))
    got = assembly.gather_tables(c["sp"], c["mesh"].connectivity)
    want = jasm.gather_tables(c["jsp"], c["mesh"].connectivity)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ops", [None, PLAIN_OPS],
                         ids=["default_ops", "plain_ops"])
def test_bcsr_matvec_and_assembly_match_reference(sparse_case, ops):
    c = sparse_case
    sp, N = c["sp"], c["N"]
    y = bcsr.bcsr_matvec(_t(c["values"]), sp.rows, sp.cols, _t(c["x"]), N,
                         ops=ops)
    yr = jbcsr.bcsr_matvec(jnp.asarray(c["values"]), jnp.asarray(sp.rows),
                           jnp.asarray(sp.cols), jnp.asarray(c["x"]), N)
    assert y.shape == (2, N) and _rel(y, yr) <= TOL
    # the same product over a rows' table made once (solve_bcsr's loop)
    table = assembly.scatter_table(sp.rows, N, "cpu")
    assert torch.equal(bcsr.bcsr_matvec_gather(
        _t(c["values"]), sp.cols, _t(c["x"]), table, ops=ops), y)
    slots = sp.slots_flat_cf()
    vals = assembly.assemble_matrix(_t(c["Ke"]), slots, sp.nnz, ops=ops)
    vr = jasm.assemble_matrix(jnp.asarray(c["Ke"]), jnp.asarray(slots),
                              sp.nnz)
    assert vals.shape == (2, 3, sp.nnz) and _rel(vals, vr) <= TOL
    conn_flat = c["mesh"].connectivity.T.reshape(-1)
    b = assembly.assemble_vector(_t(c["Fe"]), conn_flat, N, ops=ops)
    br = jasm.assemble_vector(jnp.asarray(c["Fe"]), jnp.asarray(conn_flat),
                              N)
    assert b.shape == (2, N) and _rel(b, br) <= TOL


@pytest.fixture(scope="module")
def spd_case(sparse_case):
    """An SPD block system (V = 2) on the same sparsity: per-element
    R R^T + I blocks assembled, a seeded right-hand side, and its LAPACK
    solution."""
    c = sparse_case
    sp, N, E = c["sp"], c["N"], c["mesh"].n_elems
    V, K = 2, 4
    rng = np.random.default_rng(20)
    R = rng.standard_normal((E, V * K, V * K)) * 0.3
    Me = R @ R.transpose(0, 2, 1) + np.eye(V * K)[None]
    Ke = Me.reshape(E, V, K, V, K).transpose(1, 3, 2, 4, 0)  # (V,W,K,K,E)
    values = assembly.assemble_matrix(_t(Ke), sp.slots_flat_cf(), sp.nnz)
    b = rng.standard_normal((V, N))
    A = np.zeros((V, N, V, N))
    for v in range(V):
        for w in range(V):
            A[v, sp.rows, w, sp.cols] = values[v, w].numpy()
    x = np.linalg.solve(A.reshape(V * N, -1), b.reshape(-1)).reshape(V, N)
    return dict(values=values, b=b, x=x)


@pytest.mark.parametrize("method", ["bicgstab", "cg", "gmres"])
def test_solve_bcsr_matches_reference(sparse_case, spd_case, method,
                                     monkeypatch):
    sp, c = sparse_case["sp"], spd_case
    inverted = []
    invert = assembly.invert_scatter
    monkeypatch.setattr(assembly, "invert_scatter",
                        lambda *a: inverted.append(1) or invert(*a))
    r = krylov.solve_bcsr(c["values"], sp, _t(c["b"]), method=method,
                          rtol=1e-12)
    assert len(inverted) == 1  # the rows' table, once for the whole solve
    jr = jkrylov.solve_bcsr(jnp.asarray(c["values"].numpy()),
                            sparse_case["jsp"], jnp.asarray(c["b"]),
                            method=method, rtol=1e-12)
    assert float(r.residual) <= 1e-12 and float(jr.residual) <= 1e-12
    assert 0 < r.iters < 5000
    assert _rel(r.x, jr.x) <= 1e-9 and _rel(r.x, c["x"]) <= 1e-9
    # unpreconditioned, the same solution
    r0 = krylov.solve_bcsr(c["values"], sp, _t(c["b"]), method=method,
                           rtol=1e-12, precondition=False)
    assert _rel(r0.x, c["x"]) <= 1e-9


@pytest.mark.parametrize("kind,grad_const", [("tet4", True),
                                              ("tet4", False),
                                              ("hex8", False)])
def test_block_element_matrices_match_reference(kind, grad_const):
    """On the reference's PIHNA blocks at a seeded state: on TET4 with
    taxis and diffusion (C, D and E blocks live) by the affine route
    (grad_const) and the per-q one; on HEX8 with the shipped deck's mass
    blocks (the reference's eager call meets K^2 Q terms a live block, so
    HEX8's D and E blocks would cost it seconds each)."""
    mesh = (jbox_tet_mesh(2, 2, 2) if kind == "tet4"
            else jbox_hex_mesh(2, 2, 2))
    phi, JxW, dphi = jgeometry(jnp.asarray(mesh.coords),
                               jnp.asarray(mesh.connectivity),
                               mesh.elem_type)
    rng = np.random.default_rng(21)
    Kk = 2.39e5
    p = {k: float(v) for k, v in default_params().items()}
    p.update(cells_max_capacity=Kk)
    if kind == "tet4":
        p.update(taxis_c=0.3, taxis_h=0.2, diffuse_c=0.4, diffuse_h=0.25)
    u = np.stack([rng.random(mesh.n_nodes) * s
                  for s in (0.05 * Kk, 0.1 * Kk, 0.05 * Kk, 0.03 * Kk,
                            1e-9)])
    u_qp, g_qp = jasm.interpolate_ue(jnp.asarray(u)[:, mesh.connectivity.T],
                                     phi, dphi)
    jb = jpihna_blocks(u_qp, g_qp, {}, p)
    want = jwf.block_element_matrices(jb, phi, JxW, dphi,
                                      grad_const=grad_const)
    np_ = lambda x: x if isinstance(x, float) else np.asarray(x)
    wfb = blocks_from_numpy(
        [np_(a) for a in jb.A], [np_(b) for b in jb.B],
        [[np_(x) for x in row] for row in jb.C],
        [[np_(x) for x in row] for row in jb.D],
        [[np_(x) for x in row] for row in jb.E], "cpu")
    got = weakform.block_element_matrices(wfb, phi, _t(JxW), _t(dphi),
                                          grad_const=grad_const)
    assert got.shape == want.shape and _rel(got, want) <= TOL
    dense = weakform.element_matrices(wfb.to_dense(), phi, _t(JxW),
                                      _t(dphi), grad_const=grad_const)
    assert _rel(got, dense) <= TOL


@pytest.fixture(scope="module")
def solid_case():
    """Seeded (E, Q) batches of inverse-map gradients near the identity,
    growth stretches, fibres and materials (a quarter without fibre)."""
    rng = np.random.default_rng(22)
    shape = (6, 4)
    grad_X = np.eye(3) + 0.1 * rng.standard_normal(shape + (3, 3))
    lam = 1.0 + 0.05 * rng.random(shape + (3,))
    eta = rng.standard_normal(shape + (3,))
    eta[0, 0] = 0.0  # a zero fibre
    young = 1e3 * (1.0 + rng.random(shape))
    poisson = 0.2 + 0.2 * rng.random(shape)
    fibre_k = np.where(rng.random(shape) < 0.25, 0.0, 50.0 * rng.random(shape))
    return grad_X, lam, eta, young, poisson, fibre_k


def test_kinematics_and_stress_and_tangent_match_reference(solid_case):
    grad_X, lam, *_ = solid_case
    for g, w in zip(hyperelastic.kinematics(_t(grad_X), _t(lam)),
                    jhyper.kinematics(jnp.asarray(grad_X),
                                      jnp.asarray(lam))):
        assert _rel(g, w) <= TOL
    args = [_t(a) for a in solid_case]
    jargs = [jnp.asarray(a) for a in solid_case]
    sig, tan, F = hyperelastic.stress_and_tangent(*args)
    # one compiled program: eagerly, its einsums cost seconds to compile
    jsig, jtan, jF = jax.jit(jhyper.stress_and_tangent)(*jargs)
    assert tan.shape == (6, 4, 6, 6)
    for g, w in ((sig, jsig), (tan, jtan), (F, jF)):
        assert _rel(g, w) <= TOL
    sig2, none, _ = hyperelastic.stress_and_tangent(*args,
                                                    want_tangent=False)
    assert none is None and torch.equal(sig2, sig)
    m = hyperelastic.SolidMaterial(*args[3:6], _t(np.ones((6, 3))))
    assert m._fields == jhyper.SolidMaterial._fields


def test_eig3_matches_reference():
    rng = np.random.default_rng(23)
    M = rng.standard_normal((50, 3, 3))
    A = M + M.transpose(0, 2, 1)
    A[0] = np.diag([2.0, 2.0, 2.0])      # p = 0
    A[1] = np.diag([1.0, 3.0, 3.0])      # a repeated pair
    A[2] = np.diag([3.0, -1.0, 2.0])     # axis aligned
    lam = eig3.eigvalsh3(_t(A))
    assert _rel(lam, jeig3.eigvalsh3(jnp.asarray(A))) <= 1e-12
    # the closed form (the reference's method) loses digits through
    # arccos near a double root: 1e-9 class against LAPACK here
    assert _rel(lam, np.linalg.eigvalsh(A)) <= 1e-8
    lam2, vec = eig3.eigh3(_t(A))
    jlam, jvec = jeig3.eigh3(jnp.asarray(A))
    assert torch.equal(lam2, lam)
    vec, jvec = vec.numpy(), np.asarray(jvec)
    sign = np.sign((vec * jvec).sum(axis=-2, keepdims=True))
    assert np.abs(vec - sign * jvec).max() <= 1e-12
    # the decomposition itself, off the degenerate rows
    rec = vec @ (lam.numpy()[..., None] * vec.transpose(0, 2, 1))
    assert np.abs(rec - A)[3:].max() <= 1e-8 * np.abs(A).max()


def test_newton_solve_and_solid_bc():
    """newton_solve is NewtonSolver(sp, opts).solve; on a small cubic
    system R(x) = A x + 0.1 x^3 - f over box_hex_mesh(1)'s sparsity."""
    conn = np.arange(8, dtype=np.int32)[None]
    sp = assembly.build_sparsity_numpy(conn, 8)
    rng = np.random.default_rng(24)
    V = 3
    R = rng.standard_normal((1, V * 8, V * 8)) * 0.2
    Me = R @ R.transpose(0, 2, 1) + 4.0 * np.eye(V * 8)[None]
    Ke = Me.reshape(1, V, 8, V, 8).transpose(1, 3, 2, 4, 0)
    A = assembly.assemble_matrix(_t(Ke), sp.slots_flat_cf(), sp.nnz)
    f = _t(rng.standard_normal((V, 8)))
    diag = torch.as_tensor(sp.diag_slots).long()

    def assemble(x):
        Rx = bcsr.bcsr_matvec(A, sp.rows, sp.cols, x, 8) + 0.1 * x**3 - f
        vals = A.clone()
        for v in range(V):
            vals[v, v, diag] += 0.3 * x[v] ** 2
        return Rx, vals

    opts = NewtonOptions(max_nonlinear_iterations=20,
                         relative_residual_tolerance=1e-12,
                         absolute_residual_tolerance=1e-12,
                         relative_step_tolerance=1e-14)
    x0 = torch.zeros((V, 8), dtype=torch.float64)
    got = newton_solve(assemble, x0, sp, opts, device="cpu")
    want = NewtonSolver(sp, opts, device="cpu").solve(assemble, x0)
    assert got.converged and got.iters == want.iters > 1
    assert torch.equal(got.x, want.x)
    assert float(assemble(got.x)[0].abs().max()) <= 1e-10
    assert ([f.name for f in dataclasses.fields(SolidBC)]
            == [f.name for f in dataclasses.fields(JSolidBC)])
    bc = SolidBC(3, (np.nan, 0.0, -0.05))
    assert bc.boundary_id == 3 and bc.displacement[2] == -0.05


def test_scalars_match_reference():
    d = np.array([-720.0, -30.0, 0.0, 1.0, 45.0, 90.0, 180.0, 359.9])
    r = scalars.degrees_to_radians(_t(d))
    assert np.array_equal(r.numpy(), np.asarray(jscalars.degrees_to_radians(
        jnp.asarray(d))))
    back = scalars.radians_to_degrees(r)
    assert np.array_equal(back.numpy(), np.asarray(
        jscalars.radians_to_degrees(jnp.asarray(r.numpy()))))
    assert scalars.degrees_to_radians(180.0) == jscalars.degrees_to_radians(
        180.0)
    g = lambda: torch.Generator().manual_seed(7)
    u = scalars.uniform_rand(g(), 2.0, 5.0, (40000,))
    assert u.shape == (40000,) and u.dtype == torch.float64
    assert float(u.min()) >= 2.0 and float(u.max()) < 5.0
    assert abs(float(u.mean()) - 3.5) < 0.02
    assert abs(float(u.var()) - 0.75) < 0.02
    assert torch.equal(u, scalars.uniform_rand(g(), 2.0, 5.0, (40000,)))
    n = scalars.normal_rand(g(), 1.0, 2.0, (200, 200))
    assert n.shape == (200, 200)
    assert abs(float(n.mean()) - 1.0) < 0.05
    assert abs(float(n.std()) - 2.0) < 0.05
    assert torch.equal(n, scalars.normal_rand(g(), 1.0, 2.0, (200, 200)))
    assert scalars.uniform_rand(g(), 0.0, 1.0).shape == ()


def _exports(mod) -> set:
    """A reference subpackage's exports: its __all__, else the names its
    __init__ binds at top level by relative imports, public defs and
    classes, and __version__."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    names = set()
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names |= {a.asname or a.name for a in node.names}
        elif (isinstance(node, (ast.FunctionDef, ast.ClassDef))
              and not node.name.startswith("_")):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)
                      and (t.id == "__version__" or t.id[0] != "_")}
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_api_parity(sub):
    name = lambda pkg: pkg + ("." + sub if sub else "")
    ref = importlib.import_module(name("rdcfes_tpu"))
    port = importlib.import_module(name("rdcfes_tpu_torch"))
    missing = sorted(n for n in _exports(ref) - TPU_ONLY.get(sub, set())
                     if not hasattr(port, n))
    assert not missing, f"{name('rdcfes_tpu_torch')} lacks {missing}"
