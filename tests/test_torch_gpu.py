"""The CUDA kernels of rdcfes_tpu_torch on the card: each against its plain
version on seeded NumPy inputs (f64 within 1e-13, f32 within 1e-5,
relative to the largest plain value: summation order and fused
multiply-adds only), and a short transient run and a solid load step
through the kernels against the same runs through the plain versions.

Every test needs a CUDA device and skips without one.  The file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from rdcfes_tpu_torch.fem import assembly, bcsr, kernels, weakform
from rdcfes_tpu_torch.fem.geometry import geometry_factors
from rdcfes_tpu_torch.mesh import box_hex_mesh, box_tet_mesh
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.solvers.newton import NewtonOptions
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.systems.solid import SolidSystem
from rdcfes_tpu_torch.utils.convert import blocks_from_numpy

pytestmark = pytest.mark.gpu
V = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _case(dev, live):
    mesh = box_tet_mesh(5, 4, 3, bounds=((0, 2.0), (0, 3.0), (0, 2.5)))
    phi, JxW, dphi = geometry_factors(
        torch.as_tensor(mesh.coords, device=dev),
        torch.as_tensor(mesh.connectivity, device=dev), "TET4")
    Q, E = JxW.shape
    rng = np.random.default_rng(11)
    on = lambda v, w: live == "all" or (v + 2 * w) % 3 == 0
    A = [rng.standard_normal((Q, E)) if v != 2 else 0.0 for v in range(V)]
    B = [rng.standard_normal((Q, 3, E)) if on(v, 1) else 0.0
         for v in range(V)]
    blk = lambda tail, s: [[rng.standard_normal(tail) if on(v, w + s)
                            else 0.0 for w in range(V)] for v in range(V)]
    blocks = (A, B, blk((Q, E), 0), blk((Q, 3, E), 1), blk((Q, E), 2))
    sp = assembly.build_sparsity(mesh.connectivity, mesh.n_nodes)
    ng = assembly.gather_tables(sp, mesh.connectivity)[1]
    conn_T = np.ascontiguousarray(mesh.connectivity.T)
    x = rng.standard_normal((V, mesh.n_nodes))
    return dict(phi=phi, JxW=JxW, dphi0=dphi[0].contiguous(), blocks=blocks,
                ng=torch.as_tensor(ng, device=dev),
                conn_T=torch.as_tensor(conn_T, device=dev),
                x=torch.as_tensor(x, device=dev))


@pytest.mark.parametrize("live", ["all", "some"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_apply_and_restrict_match_plain(cuda, live, dtype, tol):
    c = _case(cuda, live)
    wfb = blocks_from_numpy(*c["blocks"], cuda, dtype=dtype)
    JxW, dphi0, x = c["JxW"].to(dtype), c["dphi0"].to(dtype), c["x"].to(dtype)
    st = kernels.stack_apply(wfb, weakform.diffusion_presum(wfb, JxW))
    before = kernels.launch_counts()
    Ye = kernels.apply_affine(x, c["conn_T"], c["phi"], JxW, dphi0, st)
    ref = kernels.apply_affine_plain(x, c["conn_T"], c["phi"], JxW, dphi0, st)
    torch.cuda.synchronize()
    assert Ye.dtype == dtype and rel(Ye, ref) < tol
    flat = Ye.reshape(V, -1)
    # same gathers in the same order: equal bit for bit
    assert torch.equal(kernels.restrict(flat, c["ng"]),
                       kernels.restrict_plain(flat, c["ng"]))
    tag = "f32" if dtype == torch.float32 else "f64"
    after = kernels.launch_counts()
    assert after[f"apply_affine_{tag}"] == before[f"apply_affine_{tag}"] + 1
    assert after[f"restrict_{tag}"] == before[f"restrict_{tag}"] + 1


@pytest.mark.parametrize("live", ["all", "some"])
def test_gather_interp_and_rhs_match_plain(cuda, live):
    c = _case(cuda, live)
    wfb = blocks_from_numpy(*c["blocks"], cuda)
    out = kernels.gather_interp_affine(c["x"], c["conn_T"], c["phi"],
                                       c["dphi0"])
    ref = kernels.gather_interp_affine_plain(c["x"], c["conn_T"], c["phi"],
                                             c["dphi0"])
    assert all(rel(o, r) < 1e-13 for o, r in zip(out, ref))
    rhs = kernels.stack_rhs(wfb)
    Fe = kernels.rhs_affine(rhs, c["JxW"], c["phi"], c["dphi0"])
    assert rel(Fe, kernels.rhs_affine_plain(rhs, c["JxW"], c["phi"],
                                            c["dphi0"])) < 1e-13
    if live == "some":
        assert not Fe[2].any()  # species 2: no A, no B -> zeros


def test_wrappers_check_inputs(cuda):
    c = _case(cuda, "all")
    with pytest.raises(ValueError, match="contiguous"):
        kernels.restrict(c["x"].T.contiguous().T, c["ng"])
    with pytest.raises(TypeError):
        kernels.gather_interp_affine(c["x"].float(), c["conn_T"], c["phi"],
                                     c["dphi0"])
    with pytest.raises(TypeError):
        kernels.restrict(c["x"], c["ng"].long())


def test_transient_kernel_path_matches_plain_path(cuda):
    mesh = box_tet_mesh(4, 4, 4)
    Kk = 2.39e5
    p = default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk,
             necrosis_v=300.0 / Kk, produce_c=-2.5, switch_c2h=1.0,
             switch_h2c=1.82, switch_h2n=0.5, diffuse_v=0.5, produce_v=10.0,
             secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, decay_a=5678.4)
    rng = np.random.default_rng(0)
    u0 = np.zeros((mesh.n_nodes, 5))
    r2 = ((mesh.coords - 0.5) ** 2).sum(axis=1)
    u0[:, 1] = 2000 * np.exp(-r2 / 0.1)
    u0[:, 2] = 500 * np.exp(-r2 / 0.1)
    u0[:, 3] = 7200 * (1 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    runs = []
    for ops in (kernels.KERNEL_OPS, kernels.PLAIN_OPS):
        s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=3e-11,
                               precision="mixed", precond_refresh=2,
                               device=cuda, ops=ops)
        kernels.reset_launch_counts()
        st, _, ress = s.run_steps(s.initial_state(u0), 3, params=p)
        runs.append((st["u"].cpu().numpy(), kernels.launch_counts()))
        assert float(ress.max()) <= 3e-11
    (uk, nk), (up, npl) = runs
    assert all(nk[n] > 0 for n in kernels.TRANSIENT_VARIANTS)
    assert not any(npl.values())
    assert np.linalg.norm(uk - up) / np.linalg.norm(up) < 1e-10


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_ell_matvec_matches_plain(cuda, dtype, tol):
    """K5 on the ELL layout of a hex mesh's node-pair sparsity, with
    random block values (pad slots zero, as to_ell leaves them)."""
    mesh = box_hex_mesh(5, 4, 3)
    sp = assembly.build_sparsity(mesh.connectivity, mesh.n_nodes)
    cols, slot = assembly.ell_structure(sp)
    rng = np.random.default_rng(21)
    values = torch.as_tensor(rng.standard_normal((3, 3, sp.nnz)),
                             dtype=dtype, device=cuda)
    vell = bcsr.to_ell(values, torch.as_tensor(slot, device=cuda))
    c = torch.as_tensor(cols, device=cuda)
    x = torch.as_tensor(rng.standard_normal((3, mesh.n_nodes)), dtype=dtype,
                        device=cuda)
    tag = "f32" if dtype == torch.float32 else "f64"
    before = kernels.launch_counts()[f"ell_matvec_{tag}"]
    y = kernels.ell_matvec(vell, c, x)
    ref = bcsr.ell_matvec(vell, c, x)
    torch.cuda.synchronize()
    assert y.dtype == dtype and rel(y, ref) < tol
    assert kernels.launch_counts()[f"ell_matvec_{tag}"] == before + 1
    with pytest.raises(TypeError):
        kernels.ell_matvec(vell, c.long(), x)


def test_solid_kernel_path_matches_plain_path(cuda):
    """One load step on box_hex_mesh(4,4,4) with exact-f64 options through
    K4/K5 and through the plain versions, and the bench's f32-tangent
    options through the kernels, which launch every solid variant."""
    kw = dict(materials={0: {"young": 1.0e3, "poisson": 0.3}},
              bcs={0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)},
              penalty=1.0e6)
    exact = NewtonOptions(max_nonlinear_iterations=20,
                          relative_residual_tolerance=1e-10,
                          relative_step_tolerance=1e-10,
                          absolute_residual_tolerance=1e-10)
    xs = []
    for ops in (kernels.KERNEL_OPS, kernels.PLAIN_OPS):
        s = SolidSystem(box_hex_mesh(4, 4, 4), newton=exact, device=cuda,
                        ops=ops, **kw)
        r = s.run_solver(s.initial_positions(), 0.5)
        assert r.converged
        xs.append(r.x.cpu().numpy())
    assert np.linalg.norm(xs[0] - xs[1]) / np.linalg.norm(xs[1]) < 1e-10
    bench = NewtonOptions(max_nonlinear_iterations=20,
                          relative_residual_tolerance=1e-6,
                          relative_step_tolerance=1e-6, reuse_tangent=True,
                          linear_precision="mixed")
    s = SolidSystem(box_hex_mesh(4, 4, 4), newton=bench, device=cuda,
                    tangent_precision="f32", **kw)
    kernels.reset_launch_counts()
    r = s.run_solver(s.initial_positions(), 0.5)
    n = kernels.launch_counts()
    assert r.converged and all(n[v] > 0 for v in kernels.SOLID_VARIANTS)
