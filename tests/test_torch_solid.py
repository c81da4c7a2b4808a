"""The port's solid-mechanics modules against rdcfes_tpu on small HEX8 (and
TET4) meshes: element tables and box_hex_mesh bit-equal; geometry on a
jittered (non-affine) hex mesh, face geometry, the hyperelastic stress and
tangent (growth and fibres active) and the stress invariants within 1e-13;
the element kernels and SolidSystem.assemble within 1e-12 in f64 and 1e-5
with the f32 tangent (relative to the largest reference entry); the gather
assembly and the ELL SpMV, plain and through the K4/K5 wrappers on the
CPU, within 1e-14; the pivoted block inverse; post_process within 1e-12;
and a third witness, oracle/solid_numpy.py's nested-loop assembly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracle.solid_numpy import SolidOracle
from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import bcsr as jbcsr
from rdcfes_tpu.fem import elements as jel
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh.core import FACE_TYPE as JAX_FACE_TYPE
from rdcfes_tpu.models import eig3 as jeig3
from rdcfes_tpu.models import hyperelastic as jhyper
from rdcfes_tpu.solvers import krylov as jkrylov
from rdcfes_tpu.systems import solid as jsolid

from rdcfes_tpu_torch.fem import assembly, bcsr, elements, geometry, kernels
from rdcfes_tpu_torch.mesh import box_hex_mesh
from rdcfes_tpu_torch.mesh.core import FACE_TYPE
from rdcfes_tpu_torch.models import eig3, hyperelastic
from rdcfes_tpu_torch.solvers import krylov
from rdcfes_tpu_torch.systems import solid
from rdcfes_tpu_torch.utils.convert import (material_tables,
                                            mesh_from_reference,
                                            positions_from_numpy,
                                            positions_to_numpy)

from tests.torch_helpers import quick_compile

F32, F64 = torch.float32, torch.float64
TOL64 = 1e-13
BCS = {0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05),
       2: (0.01, np.nan, np.nan)}


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    """The reference's jit compiles, which dominate this file's time,
    without XLA's expensive passes (tests/torch_helpers.quick_compile)."""
    with quick_compile():
        yield


def rel(a, b):
    a = a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jittered_hex(n=3, seed=3):
    """box_hex_mesh(n,n,n) with seeded interior-node jitter of 0.15 h:
    trilinear, non-affine elements."""
    m = jax_box_hex_mesh(n, n, n)
    rng = np.random.default_rng(seed)
    c = m.coords.copy()
    inner = np.all((c > 1e-9) & (c < 1 - 1e-9), axis=1)
    c[inner] += 0.15 / n * rng.uniform(-1, 1, (inner.sum(), 3))
    m.coords = c
    return m


def _materials_and_fibres(mesh, seed=5):
    """Two subdomains, one with fibre stiffness and growth rates."""
    E = mesh.n_elems
    sid = (np.arange(E) % 2).astype(np.int32)
    mesh.subdomain_id = sid
    mats = {0: {"young": 1.0e3, "poisson": 0.3},
            1: {"young": 2.5e3, "poisson": 0.35, "fibre_stiffness": 40.0,
                "stretch_rate_0": 0.1, "stretch_rate_1": -0.05,
                "stretch_rate_2": 0.02}}
    fib = np.random.default_rng(seed).standard_normal((E, 3))
    return mats, fib


@pytest.fixture(scope="module")
def case():
    """A jittered 3^3 hex mesh with two materials and fibres, positions
    perturbed off the reference configuration, the reference's f64 system
    and the port's f64 and f32-tangent systems on it."""
    jm = _jittered_hex()
    mats, fib = _materials_and_fibres(jm)
    rng = np.random.default_rng(9)
    x = jm.coords + 0.02 * rng.standard_normal(jm.coords.shape)
    kw = dict(materials=mats, bcs=BCS, penalty=1.0e6, fibres=fib)
    jsys = jsolid.SolidSystem(jm, **kw)
    tm = mesh_from_reference(jm)
    tsys = {tp: solid.SolidSystem(tm, tangent_precision=tp, device="cpu",
                                  **kw) for tp in ("f64", "f32")}
    return dict(jm=jm, tm=tm, mats=mats, fib=fib, x=x, jsys=jsys, tsys=tsys)


@pytest.mark.parametrize("elem_type", ["TET4", "HEX8", "TRI3", "QUAD4"])
def test_element_tables_bit_equal(elem_type):
    for a, b in zip(elements.tabulate(elem_type), jel.tabulate(elem_type)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # HEX20 is a type of both packages now; a type of neither raises
    for a, b in zip(elements.tabulate("HEX20"), jel.tabulate("HEX20")):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        elements.tabulate("PRISM15")


@pytest.mark.parametrize("shape,bounds", [
    ((3, 3, 3), ((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))),
    ((2, 3, 4), ((0.0, 2.0), (-1.0, 1.0), (0.0, 0.5))),
])
def test_box_hex_mesh_bit_equal(shape, bounds):
    a = box_hex_mesh(*shape, bounds=bounds)
    b = jax_box_hex_mesh(*shape, bounds=bounds)
    assert a.elem_type == b.elem_type == "HEX8"
    for name in ("coords", "connectivity", "subdomain_id", "boundary_faces",
                 "boundary_elem", "boundary_side", "boundary_id"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert all(FACE_TYPE[k] == JAX_FACE_TYPE[k] for k in FACE_TYPE)
    c = mesh_from_reference(b)
    assert np.array_equal(c.boundary_id, b.boundary_id)


@pytest.mark.parametrize("dtype,tol", [(F64, TOL64), (F32, 1e-5)])
def test_geometry_factors_non_affine_hex(case, dtype, tol):
    jm = case["jm"]
    x = case["x"]
    phi, JxW, dphi = jgeo.geometry_factors(
        jnp.asarray(x), jnp.asarray(jm.connectivity), "HEX8")
    tphi, tJxW, tdphi = geometry.geometry_factors(
        _t(x, dtype), torch.as_tensor(jm.connectivity), "HEX8")
    assert np.array_equal(tphi, phi)
    assert tJxW.dtype == tdphi.dtype == dtype
    assert rel(tJxW, JxW) < tol and rel(tdphi, dphi) < tol
    # the same jittered hexes as HEX20 take the same route
    from tests.elevate import elevate_hex

    x20, conn20 = elevate_hex(x, jm.connectivity, False)
    _, JxW20, dphi20 = jgeo.geometry_factors(
        jnp.asarray(x20), jnp.asarray(conn20), "HEX20")
    _, tJxW20, tdphi20 = geometry.geometry_factors(
        _t(x20, dtype), torch.as_tensor(conn20), "HEX20")
    assert rel(tJxW20, JxW20) < tol and rel(tdphi20, dphi20) < tol
    with pytest.raises(ValueError, match="no volume element"):
        geometry.geometry_factors(_t(x), torch.as_tensor(jm.connectivity),
                                  "EDGE3")


@pytest.mark.parametrize("mesh_fn,face_type", [
    (_jittered_hex, "QUAD4"), (lambda: jax_box_tet_mesh(2, 2, 2), "TRI3")])
def test_face_geometry_factors(mesh_fn, face_type):
    m = mesh_fn()
    x = m.coords + 0.01 * np.random.default_rng(2).standard_normal(
        m.coords.shape)
    ref = jgeo.face_geometry_factors(jnp.asarray(x),
                                     jnp.asarray(m.boundary_faces), face_type)
    out = geometry.face_geometry_factors(
        _t(x), torch.as_tensor(m.boundary_faces).long(), face_type)
    for o, r in zip(out, ref):
        assert rel(o, r) < TOL64


@pytest.mark.parametrize("want_tangent", [True, False])
def test_stress_and_tangent_cf(want_tangent):
    """Growth rates and fibres active on a batch of (Q, E) points."""
    rng = np.random.default_rng(4)
    Q, E = 8, 40
    F = np.eye(3)[:, :, None, None] + 0.1 * rng.standard_normal((3, 3, Q, E))
    gX = np.linalg.inv(np.moveaxis(F, (0, 1), (-2, -1)))
    gX = np.moveaxis(gX, (-2, -1), (0, 1))
    lam = 1.0 + 0.1 * rng.standard_normal((3, E))
    eta = rng.standard_normal((3, E))
    eta[:, :5] = 0.0  # zero fibre vectors hit the guard
    young = rng.uniform(5e2, 2e3, E)
    poisson = rng.uniform(0.2, 0.45, E)
    fibre_k = np.where(np.arange(E) % 3 == 0, 0.0, 30.0)
    jout = jhyper.stress_and_tangent_cf(
        [[jnp.asarray(gX[d, r]) for r in range(3)] for d in range(3)],
        [jnp.asarray(v) for v in lam], [jnp.asarray(v) for v in eta],
        jnp.asarray(young), jnp.asarray(poisson), jnp.asarray(fibre_k),
        want_tangent=want_tangent)
    tout = hyperelastic.stress_and_tangent_cf(
        [[_t(gX[d, r]) for r in range(3)] for d in range(3)],
        [_t(v) for v in lam], [_t(v) for v in eta], _t(young), _t(poisson),
        _t(fibre_k), want_tangent=want_tangent)
    assert hyperelastic.VOIGT == jhyper.VOIGT
    for tl, jl in zip(tout, jout):
        if jl is None:
            assert tl is None
            continue
        ref = np.stack([np.stack([np.asarray(c) for c in row]) for row in jl])
        got = torch.stack([torch.stack(list(row)) for row in tl])
        assert rel(got, ref) < TOL64


def test_principal_stress_invariants():
    rng = np.random.default_rng(6)
    s = rng.standard_normal((64, 3, 3))
    s = s + np.swapaxes(s, -1, -2)
    s[0] = np.diag([2.0, 2.0, 2.0])  # VM = 0: the clamp at zero
    for o, r in zip(eig3.principal_stress_invariants(_t(s)),
                    jeig3.principal_stress_invariants(jnp.asarray(s))):
        assert np.abs(o.numpy() - np.asarray(r)).max() <= TOL64 * np.abs(
            np.asarray(r)).max()


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-5)])
def test_element_kernels_cf(case, dtype, tol):
    jm, x = case["jm"], case["x"]
    tabs = material_tables(jm.subdomain_id, case["mats"], case["fib"])
    X0e = np.transpose(jm.coords[jm.connectivity], (1, 2, 0))
    args = (tabs["young"], tabs["poisson"], tabs["fibre_k"], tabs["rates"],
            tabs["fibres"])
    Fe, Ke = jsolid.element_kernels_cf(
        "HEX8", jnp.asarray(x), jnp.asarray(jm.connectivity),
        jnp.asarray(X0e), *map(jnp.asarray, args), jnp.asarray(0.7))
    tFe, tKe = solid.element_kernels_cf(
        "HEX8", _t(x, dtype), torch.as_tensor(jm.connectivity),
        _t(X0e, dtype), *(_t(a, dtype) for a in args),
        torch.tensor(0.7, dtype=dtype))
    assert tKe.dtype == dtype and tKe.shape == Ke.shape
    assert rel(tFe, Fe) < tol and rel(tKe, Ke) < tol
    Fr, none = solid.element_kernels_cf(
        "HEX8", _t(x), torch.as_tensor(jm.connectivity), _t(X0e),
        *(_t(a) for a in args), torch.tensor(0.7, dtype=F64),
        want_tangent=False)
    assert none is None and rel(Fr, Fe) < 1e-12


@pytest.mark.parametrize("tp,tol", [("f64", 1e-12), ("f32", 1e-5)])
def test_solid_assemble(case, tp, tol):
    """SolidSystem.assemble / assemble_residual at perturbed positions
    against the reference's f64 assembly: R always f64; the tangent f64,
    or f32 under tangent_precision="f32" (the reference's own f32 path
    promotes its tangent back to f64 through the f64 quadrature weights,
    so its values are the f64 ones to ~1e-7)."""
    js, ts = case["jsys"], case["tsys"][tp]
    xT = np.ascontiguousarray(case["x"].T)
    R, vals = js.assemble(jnp.asarray(xT), jnp.asarray(0.4))  # eager
    tR, tvals = ts.assemble(_t(xT), 0.4)
    assert tR.dtype == F64
    assert tvals.dtype == (F32 if tp == "f32" else F64)
    assert rel(tR, R) < 1e-12 and rel(tvals, vals) < tol
    Rr = ts.assemble_residual(_t(xT), 0.4)
    assert rel(Rr, R) < 1e-12
    assert ts.sp.nnz == js.sp.nnz


@pytest.mark.parametrize("tp,tol", [("f64", 1e-15), ("f32", 1e-6)])
def test_penalty_scatters_equal_index_add(case, tp, tol):
    """The penalty residual (f64) and tangent terms (f64 or f32), summed
    in a fixed order through the inverse tables of their targets (K4 on
    the card), equal index_add's sums of the same terms."""
    ts = case["tsys"][tp]
    x64 = _t(case["x"])
    pt = torch.as_tensor(0.4, dtype=F64)
    g = ts.bc_groups[0]
    faces = g["faces"]
    psi, JxWf, xyz, _ = geometry.face_geometry_factors(x64, faces,
                                                       g["face_type"])
    # the residual's terms, as _penalty_bc_residual makes them
    orig = torch.einsum("qk,fkd->fqd", psi, ts.X0[faces])
    diff = xyz - orig - (pt * 1.000001 * g["disp"])[:, None, :]
    Rf = ts.penalty * torch.einsum("fq,qi,fqv->vfi", JxWf, psi,
                                   diff * g["mask"][:, None, :])
    R0 = _t(np.random.default_rng(4).standard_normal((3, ts.mesh.n_nodes)))
    want = R0.index_add(1, faces.reshape(-1), Rf.reshape(3, -1))
    assert rel(ts._penalty_bc_residual(x64, pt, R0), want.numpy()) <= 1e-15
    # the tangent's diagonal-block terms, in the tangent's precision
    dt_ = F32 if tp == "f32" else F64
    x = x64.to(dt_)
    psi, JxWf, _, _ = geometry.face_geometry_factors(x, faces,
                                                     g["face_type"])
    psi, JxWf = psi.to(dt_), JxWf.to(dt_)
    Kf = ts.penalty * torch.einsum("fq,qi,qj->fij", JxWf, psi, psi)
    eye = torch.eye(3, dtype=dt_)
    Kb = (eye[:, :, None, None, None]
          * g["mask"].T.to(dt_)[:, None, :, None, None] * Kf[None, None])
    n = ts.mesh.n_nodes
    keys = ts.sp.rows.astype(np.int64) * n + ts.sp.cols
    fc = faces.numpy()
    slots = torch.as_tensor(np.searchsorted(
        keys, fc[:, :, None] * n + fc[:, None, :]).reshape(-1))
    v0 = _t(np.random.default_rng(6).standard_normal((3, 3, ts.sp.nnz)),
            dt_)
    want = v0.index_add(2, slots, Kb.reshape(3, 3, -1))
    assert rel(ts._penalty_bc_values(x, v0), want.numpy()) <= tol


def test_assembly_gathers_and_k4_wrapper(case):
    """assemble_matrix_gather / assemble_vector_gather against the
    reference, plain and through kernels.restrict (K4's wrapper, which
    takes the plain version for CPU tensors)."""
    jm = case["jm"]
    rng = np.random.default_rng(12)
    E, K = jm.connectivity.shape
    sp = jasm.build_sparsity(jm.connectivity, jm.n_nodes)
    tsp = assembly.build_sparsity(jm.connectivity, jm.n_nodes)
    sg = jasm.invert_scatter(sp.slots_flat_cf(), sp.nnz)
    ng = jasm.invert_scatter(jm.connectivity.T.reshape(-1), jm.n_nodes)
    assert np.array_equal(sg, assembly.invert_scatter(tsp.slots_flat_cf(),
                                                      tsp.nnz))
    Ke = rng.standard_normal((3, 3, K, K, E))
    Fe = rng.standard_normal((3, K, E))
    refM = jasm.assemble_matrix_gather(jnp.asarray(Ke), jnp.asarray(sg))
    refV = jasm.assemble_vector_gather(jnp.asarray(Fe), jnp.asarray(ng))
    for op in (assembly.restrict, kernels.restrict):
        m = assembly.assemble_matrix_gather(_t(Ke), torch.as_tensor(sg), op)
        v = assembly.assemble_vector_gather(_t(Fe), torch.as_tensor(ng), op)
        assert m.shape == (3, 3, sp.nnz) and v.shape == (3, jm.n_nodes)
        assert rel(m, refM) < 1e-14 and rel(v, refV) < 1e-14


@pytest.mark.parametrize("elem,L", [("HEX8", 27), ("TET4", 15)])
def test_ell_structure_and_k5_wrapper(elem, L):
    """ell_structure bit-equal; to_ell, ell_matvec (plain and kernels.
    ell_matvec on the CPU) and extract_diagonal_blocks against the
    reference, f64 and f32: on the jittered hex mesh (ELL width 27) and
    on box_tet_mesh(3,3,3) (width 15, the TET4 solid's)."""
    jm = _jittered_hex() if elem == "HEX8" else jax_box_tet_mesh(3, 3, 3)
    sp = jasm.build_sparsity(jm.connectivity, jm.n_nodes)
    cols, slot = jasm.ell_structure(sp)
    tcols, tslot = assembly.ell_structure(
        assembly.build_sparsity(jm.connectivity, jm.n_nodes))
    assert np.array_equal(cols, tcols) and np.array_equal(slot, tslot)
    assert cols.shape[0] == L  # the nodes an interior node touches
    rng = np.random.default_rng(13)
    values = rng.standard_normal((3, 3, sp.nnz))
    x = rng.standard_normal((3, jm.n_nodes))
    vell = jbcsr.to_ell(jnp.asarray(values), jnp.asarray(slot))
    ref = jbcsr.ell_matvec(vell, jnp.asarray(cols), jnp.asarray(x))
    tc = torch.as_tensor(tcols)
    tvell = bcsr.to_ell(_t(values), torch.as_tensor(tslot))
    assert rel(tvell, vell) == 0.0
    for fn in (bcsr.ell_matvec, kernels.ell_matvec):
        assert rel(fn(tvell, tc, _t(x)), ref) < 1e-14
        y32 = fn(tvell.to(F32), tc, _t(x, F32))
        assert y32.dtype == F32 and rel(y32, ref) < 1e-5
    D = bcsr.extract_diagonal_blocks(_t(values),
                                     torch.as_tensor(sp.diag_slots))
    assert rel(D, jbcsr.extract_diagonal_blocks(
        jnp.asarray(values), jnp.asarray(sp.diag_slots))) == 0.0


def test_pivoted_small_block_inverse():
    """Blocks with a zero (or tiny) leading entry need partial pivoting;
    the pivoted inverse matches the reference's and inverts D."""
    rng = np.random.default_rng(14)
    N = 50
    D = rng.standard_normal((3, 3, N))
    D[0, 0, :10] = 0.0
    D[0, 0, 10:20] = 1e-14
    D[:, :, 20:30] *= np.array([1e6, 1.0, 1.0])[:, None, None]  # penalty
    out = krylov.small_block_inverse(_t(D))
    ref = jkrylov.small_block_inverse(jnp.asarray(D), pivot=True)
    assert rel(out, ref) < 1e-12
    eye = np.einsum("vwn,wun->vun", D, out.numpy())
    assert np.allclose(eye, np.eye(3)[:, :, None], atol=1e-9)
    assert not torch.isfinite(krylov.small_block_inverse(
        _t(D), pivot=False)[:, :, :10]).all()
    vals = rng.standard_normal((3, 3, 80))
    diag = rng.permutation(80)[:N].astype(np.int32)
    vals[:, :, diag] = D
    bj = krylov.block_jacobi_inverse(_t(vals), torch.as_tensor(diag))
    jbj = jkrylov.block_jacobi_inverse(jnp.asarray(vals), jnp.asarray(diag))
    assert rel(bj, jbj) < 1e-12


def test_post_process(case):
    js, ts = case["jsys"], case["tsys"]["f64"]
    x = case["x"]
    ref = js._post_impl(jnp.asarray(x), jnp.asarray(0.6))  # eager
    out = ts.post_process(positions_from_numpy(x, "cpu"), 0.6)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and rel(o, r) < 1e-12
    u = ts.displacement(positions_from_numpy(x, "cpu"))
    assert np.array_equal(positions_to_numpy(u), x - case["jm"].coords)


def test_assembly_matches_numpy_oracle():
    """A witness independent of both packages: the nested-loop NumPy
    transcription of the reference app's assembly (oracle/solid_numpy.py)
    on box_hex_mesh(2,2,2): R and K @ x_test at perturbed positions."""
    m = box_hex_mesh(2, 2, 2)
    bcs = {0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)}
    rng = np.random.default_rng(15)
    x = m.coords + 0.02 * rng.standard_normal(m.coords.shape)
    orc = SolidOracle(m, young=1.0e3, poisson=0.3, penalty=1.0e6, bcs=bcs)
    R_o, K_o = orc.assemble(x, 0.5)
    s = solid.SolidSystem(m, {0: {"young": 1.0e3, "poisson": 0.3}}, bcs,
                          penalty=1.0e6, device="cpu")
    R, vals = s.assemble(_t(x.T.copy()), 0.5)
    xt = rng.standard_normal((m.n_nodes, 3))
    rows = torch.as_tensor(s.sp.rows).long()
    cols = torch.as_tensor(s.sp.cols).long()
    prod = torch.einsum("vws,ws->vs", vals, _t(xt.T)[:, cols])
    Kx = torch.zeros(3, m.n_nodes, dtype=F64).index_add(1, rows, prod)
    assert rel(R.T.reshape(-1), R_o) < 1e-12
    assert rel(Kx.T.reshape(-1), K_o @ xt.reshape(-1)) < 1e-12


def test_unported_solid_options_raise(case):
    """The multi-device solve, which raised until it was ported, builds
    the halo Newton on its shards (its solves are held in tests/
    test_torch_solid_halo.py), and refuses hanging-node constraints with
    ValueError, as the reference's does; a MixedMesh and hanging-node
    constraints build (their solves are held to the reference in tests/
    test_torch_solid_ext.py); element types the reference refuses and
    unknown precisions raise ValueError."""
    tm, mats = case["tm"], case["mats"]
    halo = solid.SolidSystem(tm, mats, BCS, device="cpu",
                             device_mesh=2)._halo
    assert halo.plan.D == 2 and halo.face_types == ["QUAD4"]
    with pytest.raises(ValueError, match="single-chip only"):
        solid.SolidSystem(tm, mats, BCS, device="cpu", device_mesh=2,
                          constraints=np.array([[0, 1, 2]]))
    mixed = solid.SolidSystem(mesh_from_reference(jax_box_mixed_mesh(3, 2, 2)),
                              mats, BCS, device="cpu")
    assert [g["face_type"] for g in mixed.bc_groups] == ["QUAD4", "TRI3"]
    assert len(mixed.blocks) == 3
    cons = solid.SolidSystem(tm, mats, BCS, device="cpu",
                             constraints=np.array([[0, 1, 2]]))._newton.cons
    assert cons.n_hanging == 1
    prism = mesh_from_reference(jax_box_tet_mesh(1, 1, 1))
    prism.elem_type = "PRISM6"
    for kw in ({"tangent_precision": "bf16"}, {}):
        with pytest.raises(ValueError):
            solid.SolidSystem(tm if kw else prism, mats, BCS, device="cpu",
                              **kw)


def test_tet4_solid_assemble():
    """The TET4 path (affine geometry, TRI3 penalty faces) of the f64
    assembly against the reference on box_tet_mesh(2,2,2)."""
    jm = jax_box_tet_mesh(2, 2, 2)
    bcs = {0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)}
    kw = dict(materials={0: {"young": 1.0e3, "poisson": 0.3}}, bcs=bcs,
              penalty=1.0e6)
    x = jm.coords + 0.02 * np.random.default_rng(16).standard_normal(
        jm.coords.shape)
    xT = np.ascontiguousarray(x.T)
    R, vals = jsolid.SolidSystem(jm, **kw)._assemble_jit(
        jnp.asarray(xT), jnp.asarray(0.5))
    ts = solid.SolidSystem(mesh_from_reference(jm), device="cpu", **kw)
    tR, tvals = ts.assemble(_t(xT), 0.5)
    assert rel(tR, R) < 1e-12 and rel(tvals, vals) < 1e-12
