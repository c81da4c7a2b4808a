"""The CUDA kernels of rdcfes_tpu_torch on the card: each against its plain
version on seeded NumPy inputs (f64 within 1e-13, f32 within 1e-5,
relative to the largest plain value: summation order and fused
multiply-adds only), and a short transient run and a solid load step
through the kernels against the same runs through the plain versions; K6
(the generic element apply, HEX8), K7 (the calibration lookup) and K8 (the
generic gather + interpolation) the same way, and ADPM steps on HEX8
through K8, K6 and K4; the K6 and K8 instances of PRISM6, PYRAMID5 and
TET10 (f32 within 1e-6) and three MixedTransientRDCSystem steps and a
TET10 step through the kernels against the plain versions; the f32
instances of K1 and K2 (TET4, TRI3) and of K8 (every element type) within
1e-5, and f32 systems (TET4, HEX8, mixed) through the kernels against the
plain versions, only f32 instances launched; the K1-K3
instances of TRI3 and the K6 and K8 instances of QUAD4, QUAD8, QUAD9,
HEX20 and HEX27, PIHNA steps on TRI3, QUAD9 and HEX27 and a dense-path
step and `assemble` through the kernels against the plain versions; K8's
HEX20 and HEX27 instances over three element tiles, the last ragged, on
shuffled elements at 1, 5 and 8 species (f64 within 1e-13, f32 1e-5); K6
at 1 to 8 species on a mesh whose element count is odd, K4 at widths 1 to 25, and both on a side stream; K5 on the TET4
and HEX8 ELL structures and on widths and block shapes outside them, two
launches bit-equal and one on a side stream, also on the solid's TET10
and mixed structures; a solid load step on a MixedMesh, on TET10 and
with hanging nodes through K4/K5 against the plain versions; the
multi-device halo system on 3 shards of the card (TET4, HEX8) through
the kernels against the plain versions and the single-device system;
the moving mesh on 4 shards (TET4, HEX8, MIXED) and the solid's halo
Newton on 4 shards (HEX8, MIXED) the same way, with every instance's
launch count checked against the steps' own count; the replicated-iterate
system (parallel.sharding) on 3 shards and the block-CSR helpers
(bcsr_matvec, assemble_matrix / assemble_vector, solve_bcsr) through K4.

Every test needs a CUDA device and skips without one.  The file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from rdcfes_tpu_torch.fem import assembly, bcsr, kernels, weakform
from rdcfes_tpu_torch.fem.geometry import geometry_factors
from rdcfes_tpu_torch.mesh import (box_hex_mesh, box_mixed_mesh,
                                   box_quad_mesh, box_tet_mesh, box_tri_mesh,
                                   tet4_to_tet10)
from rdcfes_tpu_torch.mesh.core import Mesh
from rdcfes_tpu_torch.models import adpm
from rdcfes_tpu_torch.models.pihna import (default_params, pihna_blocks,
                                           pihna_physics)
from rdcfes_tpu_torch.solvers.newton import NewtonOptions
from rdcfes_tpu_torch.systems import (MixedTransientRDCSystem,
                                      TransientRDCSystem)
from rdcfes_tpu_torch.systems.solid import SolidSystem
from rdcfes_tpu_torch.utils.convert import blocks_from_numpy
from elevate import elevate_hex, elevate_quad  # tests/elevate.py

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
    ng = assembly.block_node_gather([mesh.connectivity], mesh.n_nodes)
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
    with pytest.raises(ValueError, match="contiguous"):
        kernels.restrict(c["x"], c["ng"].T.contiguous().T)
    with pytest.raises(ValueError, match="on cpu"):
        kernels.restrict(c["x"], c["ng"].cpu())
    # K6: the per-call x and the once-per-step tables and stacks
    h = _hex_case(cuda, "some")
    wfb = blocks_from_numpy(*h["blocks"], cuda)
    st = kernels.stack_apply_generic(wfb)
    args = (h["conn_T"], h["phi"], h["JxW"], h["dphi"], st)
    kernels.apply_generic(h["x"], *args)  # a valid call makes the plan
    with pytest.raises(TypeError):
        kernels.apply_generic(h["x"].float(), *args)
    with pytest.raises(ValueError, match="shape"):
        kernels.apply_generic(h["x"][:, :-1].contiguous(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.apply_generic(h["x"].T.contiguous().T, *args)
    with pytest.raises(ValueError, match="on cuda"):
        kernels.apply_generic(h["x"], h["conn_T"], h["phi"], h["JxW"].cpu(),
                              h["dphi"], st)
    with pytest.raises(TypeError):
        kernels.apply_generic(h["x"], h["conn_T"].long(), h["phi"], h["JxW"],
                              h["dphi"], st)
    with pytest.raises(TypeError):  # f64 stacks under an f32 operator
        kernels.apply_generic(h["x"].float(), h["conn_T"], h["phi"],
                              h["JxW"].float(), h["dphi"].float(), st)


def test_launches_follow_the_current_stream(cuda):
    """K4 and K6 launch on the stream current at the call: the input is
    doubled on a side stream behind a long device sleep, so a launch on
    any other stream would read it undoubled."""
    c = _case(cuda, "all")
    h = _hex_case(cuda, "some")
    st = kernels.stack_apply_generic(blocks_from_numpy(*h["blocks"], cuda))
    K, E = c["conn_T"].shape
    flat = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (V, K * E)), device=cuda)
    x = h["x"].clone()
    kernels.restrict(flat, c["ng"])  # plans made outside the check
    kernels.apply_generic(x, h["conn_T"], h["phi"], h["JxW"], h["dphi"], st)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        flat.mul_(2.0)
        x.mul_(2.0)
        y = kernels.restrict(flat, c["ng"])
        Ye = kernels.apply_generic(x, h["conn_T"], h["phi"], h["JxW"],
                                   h["dphi"], st)
    side.synchronize()
    assert torch.equal(y, kernels.restrict_plain(flat, c["ng"]))
    ref = kernels.apply_generic_plain(x, h["conn_T"], h["phi"], h["JxW"],
                                      h["dphi"], st)
    assert rel(Ye, ref) < 1e-13


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


def _ell_case(kind, V, W, dev, dtype, seed=21):
    """(values_ell (V, W, L, N), cols (L, N), x (W, N)) for K5: the ELL
    layout of a mesh's node-pair sparsity with random block values (pad
    slots zero, as to_ell leaves them), or ("random", L, N) a table of
    random columns of width L."""
    rng = np.random.default_rng(seed)
    if kind[0] == "random":
        _, L, N = kind
        cols = rng.integers(0, N, (L, N)).astype(np.int32)
        vell = torch.as_tensor(rng.standard_normal((V, W, L, N)),
                               dtype=dtype, device=dev)
    else:
        mesh = kind[0](*kind[1:])
        N = mesh.n_nodes
        sp = (assembly.build_sparsity_mixed(mesh.blocks, N)[0]
              if mesh.elem_type == "MIXED"
              else assembly.build_sparsity(mesh.connectivity, N))
        cols, slot = assembly.ell_structure(sp)
        values = torch.as_tensor(rng.standard_normal((V, W, sp.nnz)),
                                 dtype=dtype, device=dev)
        vell = bcsr.to_ell(values, torch.as_tensor(slot, device=dev))
    x = torch.as_tensor(rng.standard_normal((W, N)), dtype=dtype,
                        device=dev)
    return vell, torch.as_tensor(cols, device=dev), x


# (structure, V, W, the ELL width it must have)
ELL_CASES = {
    "tet4": ((box_tet_mesh, 5, 4, 3), 3, 3, 15),
    "hex8": ((box_hex_mesh, 5, 4, 3), 3, 3, 27),
    # 294 nodes: more than one node tile, the last one ragged
    "hex8-ragged": ((box_hex_mesh, 6, 6, 5), 3, 3, 27),
    # 68,921 nodes: many blocks on every SM
    "hex8-large": ((box_hex_mesh, 40, 40, 40), 3, 3, 27),
    "width7": (("random", 7, 1000), 3, 3, 7),
    "width1": (("random", 1, 333), 3, 3, 1),
    "tet4-V5-W2": ((box_tet_mesh, 5, 4, 3), 5, 2, 15),
    "hex8-V4-W1": ((box_hex_mesh, 5, 4, 3), 4, 1, 27),
    "width9-V2-W8": (("random", 9, 517), 2, 8, 9),
    # 10 slots a group: passes of 4, 4 and 2
    "width37": (("random", 37, 700), 3, 3, 37),
    # the solid's TET10 structure (65 slots a row: passes of 4 over 17
    # slots a group) and the union structure of a MixedMesh
    "tet10": ((lambda n: tet4_to_tet10(box_tet_mesh(n, n, n)), 4), 3, 3,
              65),
    "mixed": ((box_mixed_mesh, 5, 4, 3), 3, 3, 27),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(ELL_CASES))
def test_ell_matvec_matches_plain(cuda, case, dtype, tol):
    """K5 against its plain version on the TET4 and HEX8 ELL structures
    (widths 15 and 27), a ragged last node tile, a large system, other
    widths (7, 1, 9, and 37: three passes a slot group) and blocks with
    V != W or W = 1; two launches bit-equal, and a launch on a side
    stream equal to them."""
    kind, V, W, L = ELL_CASES[case]
    vell, c, x = _ell_case(kind, V, W, cuda, dtype)
    assert vell.shape[:3] == (V, W, L)
    tag = "f32" if dtype == torch.float32 else "f64"
    before = kernels.launch_counts()[f"ell_matvec_{tag}"]
    y = kernels.ell_matvec(vell, c, x)
    ref = bcsr.ell_matvec(vell, c, x)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (V, vell.shape[3])
    assert rel(y, ref) < tol
    assert kernels.launch_counts()[f"ell_matvec_{tag}"] == before + 1
    assert torch.equal(kernels.ell_matvec(vell, c, x), y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ys = kernels.ell_matvec(vell, c, x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(ys, y)
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


@pytest.mark.parametrize("kind", ["mixed", "tet10", "constrained"])
def test_solid_ext_kernel_path_matches_plain_path(cuda, kind):
    """A load step on a MixedMesh, a TET10 mesh and a MixedMesh with
    hanging nodes (its TET4 block refined 1:8 near the centre) with
    exact-f64 options through K4/K5 and through the plain versions
    (relative L2 within 1e-10, hanging nodes on their masters' midpoint
    within 1e-12), then with the card's f32 tangent and mixed Krylov
    through the kernels, which launch every solid variant."""
    from rdcfes_tpu_torch.mesh import MixedConstrained

    cons = None
    if kind == "tet10":
        mesh = tet4_to_tet10(box_tet_mesh(3, 3, 3))
    else:
        mesh = box_mixed_mesh(4, 3, 3)
    if kind == "constrained":
        conn4 = np.concatenate([b.connectivity[:, :4] for b in mesh.blocks])
        r = np.linalg.norm(mesh.coords[conn4].mean(axis=1) - 0.5, axis=1)
        out = MixedConstrained.from_mesh(mesh).refine_and_coarsen(
            r <= np.quantile(r, 0.3), np.zeros(mesh.n_elems, bool))
        mesh, cons = out.mesh, out.constraints
        assert len(cons)
    kw = dict(materials={0: {"young": 1.0e3, "poisson": 0.3}},
              bcs={0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)},
              penalty=1.0e6, constraints=cons)
    exact = NewtonOptions(max_nonlinear_iterations=20,
                          relative_residual_tolerance=1e-10,
                          relative_step_tolerance=1e-10,
                          absolute_residual_tolerance=1e-10)
    xs = []
    for ops in (kernels.KERNEL_OPS, kernels.PLAIN_OPS):
        s = SolidSystem(mesh, newton=exact, device=cuda, ops=ops, **kw)
        r = s.run_solver(s.initial_positions(), 0.5)
        assert r.converged
        xs.append(r.x.cpu().numpy())
    assert np.linalg.norm(xs[0] - xs[1]) / np.linalg.norm(xs[1]) < 1e-10
    if cons is not None:
        h, a, b = cons.T
        for x in xs:
            assert np.abs(x[h] - 0.5 * (x[a] + x[b])).max() <= 1e-12
    bench = NewtonOptions(max_nonlinear_iterations=20,
                          relative_residual_tolerance=1e-6,
                          relative_step_tolerance=1e-6, reuse_tangent=True,
                          linear_precision="mixed")
    s = SolidSystem(mesh, newton=bench, device=cuda, tangent_precision="f32",
                    **kw)
    kernels.reset_launch_counts()
    r = s.run_solver(s.initial_positions(), 0.5)
    n = kernels.launch_counts()
    assert r.converged and all(n[v] > 0 for v in kernels.SOLID_VARIANTS)


def _hex_case(dev, live, n_vars=V, dims=(4, 3, 3)):
    """Seeded blocks on a jittered hex box: per-q gradients.  live="some"
    leaves blocks out by a pattern, and the last species with no block
    at all."""
    mesh = box_hex_mesh(*dims, bounds=((0, 2.0), (0, 3.0), (0, 2.5)))
    rng = np.random.default_rng(31)
    coords = mesh.coords + 0.04 * rng.standard_normal(mesh.coords.shape)
    phi, JxW, dphi = geometry_factors(
        torch.as_tensor(coords, device=dev),
        torch.as_tensor(mesh.connectivity, device=dev), "HEX8")
    Q, E = JxW.shape
    nv = n_vars
    on = lambda v, w: live == "all" or (
        (v + 2 * w) % 3 == 0 and (v < nv - 1 or nv == 1))
    blk = lambda tail, s: [[rng.standard_normal(tail) if on(v, w + s)
                            else 0.0 for w in range(nv)] for v in range(nv)]
    blocks = ([rng.standard_normal((Q, E)) for _ in range(nv)], [0.0] * nv,
              blk((Q, E), 0), blk((Q, 3, E), 1), blk((Q, E), 2))
    conn_T = np.ascontiguousarray(mesh.connectivity.T)
    return dict(phi=phi, JxW=JxW, dphi=dphi.contiguous(), blocks=blocks,
                conn_T=torch.as_tensor(conn_T, device=dev),
                x=torch.as_tensor(rng.standard_normal((nv, mesh.n_nodes)),
                                  device=dev))


@pytest.mark.parametrize("live", ["all", "some"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_apply_generic_matches_plain(cuda, live, dtype, tol):
    c = _hex_case(cuda, live)
    wfb = blocks_from_numpy(*c["blocks"], cuda, dtype=dtype)
    JxW, dphi, x = c["JxW"].to(dtype), c["dphi"].to(dtype), c["x"].to(dtype)
    st = kernels.stack_apply_generic(wfb)
    tag = "f32" if dtype == torch.float32 else "f64"
    before = kernels.launch_counts()[f"apply_generic_{tag}"]
    Ye = kernels.apply_generic(x, c["conn_T"], c["phi"], JxW, dphi, st)
    ref = kernels.apply_generic_plain(x, c["conn_T"], c["phi"], JxW, dphi,
                                      st)
    torch.cuda.synchronize()
    assert Ye.dtype == dtype and rel(Ye, ref) < tol
    assert kernels.launch_counts()[f"apply_generic_{tag}"] == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        kernels.apply_generic(x, c["conn_T"], c["phi"], JxW,
                              dphi.transpose(0, 1), st)
    with pytest.raises(ValueError, match="K="):  # TET4 is K3's, not K6's
        kernels.apply_generic(x, c["conn_T"][:4], c["phi"][:5, :4], JxW[:5],
                              dphi[:5, :4].contiguous(), st)


@pytest.mark.parametrize("n_vars", [1, 3, 5, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_apply_generic_odd_e_matches_plain(cuda, n_vars, dtype, tol):
    """K6 on box_hex_mesh(5,5,5): E = 125 is odd (rows not 16-byte
    aligned) and not a multiple of the tile; absent blocks and, beyond one
    species, a species with none; one launch counted per call."""
    c = _hex_case(cuda, "some", n_vars=n_vars, dims=(5, 5, 5))
    wfb = blocks_from_numpy(*c["blocks"], cuda, dtype=dtype)
    JxW, dphi, x = c["JxW"].to(dtype), c["dphi"].to(dtype), c["x"].to(dtype)
    st = kernels.stack_apply_generic(wfb)
    tag = "f32" if dtype == torch.float32 else "f64"
    before = kernels.launch_counts()[f"apply_generic_{tag}"]
    for i in range(2):
        Ye = kernels.apply_generic(x, c["conn_T"], c["phi"], JxW, dphi, st)
        assert (kernels.launch_counts()[f"apply_generic_{tag}"]
                == before + i + 1)
    ref = kernels.apply_generic_plain(x, c["conn_T"], c["phi"], JxW, dphi,
                                      st)
    torch.cuda.synchronize()
    assert Ye.shape == (n_vars, 8, 125)
    assert rel(Ye, ref) < tol
    if n_vars > 1:
        assert not Ye[-1].any()


@pytest.mark.parametrize("W", [1, 5, 9, 25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restrict_bit_equal_any_width(cuda, W, dtype):
    """K4 on a table whose nodes have 0 to C incidences (C = 13, not a
    multiple of the kernel's chunk), tail-padded as invert_scatter pads,
    and on one with pads in the middle: equal to the plain version bit
    for bit, one launch counted per call."""
    rng = np.random.default_rng(W)
    C, N, KE = 13, 1001, 4000
    counts = rng.integers(0, C + 1, N)
    ng = np.full((C, N), KE, np.int32)
    for n in range(N):
        ng[:counts[n], n] = rng.choice(KE, counts[n], replace=False)
    holes = ng.copy()
    holes[rng.random((C, N)) < 0.2] = KE
    flat = torch.as_tensor(rng.standard_normal((W, KE)), dtype=dtype,
                           device=cuda)
    tag = "f32" if dtype == torch.float32 else "f64"
    for table in (ng, holes):
        t = torch.as_tensor(table, device=cuda)
        before = kernels.launch_counts()[f"restrict_{tag}"]
        y = kernels.restrict(flat, t)
        assert kernels.launch_counts()[f"restrict_{tag}"] == before + 1
        assert y.shape == (W, N)
        assert torch.equal(y, kernels.restrict_plain(flat, t))


@pytest.mark.parametrize("n_vars", [1, 3, V])
def test_gather_interp_generic_matches_plain(cuda, n_vars):
    """K8 on a jittered hex box, 1, 3 and 5 species, within 1e-13 of its
    plain version (gather + interpolate_ue)."""
    c = _hex_case(cuda, "all")
    x = c["x"][:n_vars].contiguous()
    before = kernels.launch_counts()["gather_interp_generic_f64"]
    out = kernels.gather_interp_generic(x, c["conn_T"], c["phi"], c["dphi"])
    ref = kernels.gather_interp_generic_plain(x, c["conn_T"], c["phi"],
                                              c["dphi"])
    torch.cuda.synchronize()
    E = c["conn_T"].shape[1]
    assert out[0].shape == (n_vars, 8, E) and out[1].shape == (n_vars, 8, 3, E)
    assert all(rel(o, r) < 1e-13 for o, r in zip(out, ref))
    assert (kernels.launch_counts()["gather_interp_generic_f64"]
            == before + 1)
    with pytest.raises(TypeError):
        kernels.gather_interp_generic(x.float(), c["conn_T"], c["phi"],
                                      c["dphi"])
    with pytest.raises(ValueError, match="K="):  # TET4 is K1's, not K8's
        kernels.gather_interp_generic(x, c["conn_T"][:4], c["phi"][:5, :4],
                                      c["dphi"][:5, :4].contiguous())


def test_take_along_matches_plain(cuda):
    rng = np.random.default_rng(0)
    tbl = torch.as_tensor(rng.standard_normal((192, 128)),
                          dtype=torch.float32, device=cuda)
    idx = torch.as_tensor(rng.integers(0, 192, (4608, 128)),
                          dtype=torch.int32, device=cuda)
    before = kernels.launch_counts()["take_along_f32"]
    out = kernels.take_along(tbl, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.take_along_plain(tbl, idx))
    assert kernels.launch_counts()["take_along_f32"] == before + 1
    with pytest.raises(TypeError):
        kernels.take_along(tbl, idx.long())


def test_hex8_kernel_path_matches_plain_path(cuda):
    """3 ADPM steps (live D planes, fields) on box_hex_mesh(4,4,4), each
    from a common state, through K8/K6/K4 and through the plain versions,
    in mixed precision and in f64 with GMRES."""
    mesh = box_hex_mesh(4, 4, 4, bounds=((0, 20.0),) * 3)
    p = adpm.default_params()
    p.update(dt=0.05, decay_PrP=1e-4, decay_PrP_pulse0=0.01,
             decay_PrP_pulse1=10.0, diffuse_A_b=0.05, taxis1_A_b=0.5,
             taxis2_A_b=0.2, decay_A_b=0.05, diffuse_Tau=0.02,
             taxis1_Tau=0.3, decay_Tau=1.0)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(5)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 0.3 * np.exp(-r2 / 30.0)
    u0[:, 2] = 0.1 * np.exp(-r2 / 20.0)
    tr = rng.standard_normal((mesh.n_elems, 3))
    tr /= np.linalg.norm(tr, axis=1, keepdims=True)
    f = {"tracts": torch.as_tensor(tr, device=cuda), "time": 1.0}
    for kw in ({"precision": "mixed"},
               {"precision": "f64", "method": "gmres"}):
        a = TransientRDCSystem(mesh, 3, adpm.adpm_blocks, rtol=1e-11,
                               device=cuda, **kw)
        b = TransientRDCSystem(mesh, 3, adpm.adpm_blocks, rtol=1e-11,
                               device=cuda, ops=kernels.PLAIN_OPS, **kw)
        kernels.reset_launch_counts()
        sa = a.initial_state(u0)
        for _ in range(3):
            sb, _, _ = b.step(sa, fields=f, params=p)
            sa, _, res = a.step(sa, fields=f, params=p)
            assert float(res) <= 1e-11
            ua, ub = sa["u"].cpu().numpy(), sb["u"].cpu().numpy()
            assert np.linalg.norm(ua - ub) / np.linalg.norm(ub) < 1e-10
        n = kernels.launch_counts()
        assert n["apply_generic_f64"] > 0 and n["restrict_f64"] > 0
        assert n["gather_interp_generic_f64"] == 3
        assert (n["apply_generic_f32"] > 0) == (kw["precision"] == "mixed")


def _prism_block(n):
    """(coords, conn) of box_hex_mesh(n, n, n)'s cells each split into two
    PRISM6 (bottom triangle counterclockwise seen from above)."""
    m = box_hex_mesh(n, n, n)
    c = m.connectivity
    conn = np.concatenate([c[:, [0, 1, 2, 4, 5, 6]], c[:, [0, 2, 3, 4, 6, 7]]])
    return m.coords, conn


def _block(elem_type):
    """(coords, conn) of a small block of one element type."""
    if elem_type in ("QUAD4", "QUAD8", "QUAD9"):
        m = box_quad_mesh(7, 5)
        if elem_type == "QUAD4":
            return m.coords, m.connectivity
        return elevate_quad(m.coords, m.connectivity, elem_type == "QUAD9")
    if elem_type in ("HEX20", "HEX27"):
        m = box_hex_mesh(3, 3, 2)
        return elevate_hex(m.coords, m.connectivity, elem_type == "HEX27")
    if elem_type == "PRISM6":
        return _prism_block(3)
    if elem_type == "TET10":
        m = tet4_to_tet10(box_tet_mesh(3, 3, 2))
        return m.coords, m.connectivity
    m = box_mixed_mesh(5, 3, 3)
    b = next(b for b in m.blocks if b.elem_type == elem_type)
    return m.coords, b.connectivity


NEW_TYPES = {"PYRAMID5": "pyramid5", "PRISM6": "prism6", "TET10": "tet10",
             "QUAD4": "quad4", "QUAD8": "quad8", "QUAD9": "quad9",
             "HEX20": "hex20", "HEX27": "hex27"}


def _elem_case(dev, elem_type, n_vars=V):
    """Seeded blocks (some absent) on a jittered block of elem_type."""
    coords, conn = _block(elem_type)
    rng = np.random.default_rng(41)
    coords = coords + 0.02 * rng.standard_normal(coords.shape)
    phi, JxW, dphi = geometry_factors(torch.as_tensor(coords, device=dev),
                                      torch.as_tensor(conn, device=dev),
                                      elem_type)
    Q, E = JxW.shape
    on = lambda v, w: (v + 2 * w) % 3 != 1
    blk = lambda tail, s: [[rng.standard_normal(tail) if on(v, w + s)
                            else 0.0 for w in range(n_vars)]
                           for v in range(n_vars)]
    blocks = ([rng.standard_normal((Q, E)) for _ in range(n_vars)],
              [0.0] * n_vars, blk((Q, E), 0), blk((Q, 3, E), 1),
              blk((Q, E), 2))
    return dict(phi=phi, JxW=JxW, dphi=dphi.contiguous(), blocks=blocks,
                conn_T=torch.as_tensor(np.ascontiguousarray(conn.T),
                                       device=dev),
                x=torch.as_tensor(rng.standard_normal((n_vars, len(coords))),
                                  device=dev))


@pytest.mark.parametrize("elem_type", list(NEW_TYPES))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
def test_apply_generic_new_instances_match_plain(cuda, elem_type, dtype,
                                                 tol):
    """K6 at PYRAMID5 (5, 8), PRISM6 (6, 8), TET10 (10, 14), QUAD4 (4, 4),
    QUAD8 (8, 9), QUAD9 (9, 9), HEX20 (20, 27) and HEX27 (27, 27): one
    launch counted under the variant and under the instance."""
    c = _elem_case(cuda, elem_type)
    wfb = blocks_from_numpy(*c["blocks"], cuda, dtype=dtype)
    JxW, dphi, x = c["JxW"].to(dtype), c["dphi"].to(dtype), c["x"].to(dtype)
    st = kernels.stack_apply_generic(wfb)
    tag = "f32" if dtype == torch.float32 else "f64"
    inst = f"apply_generic_{tag}:{NEW_TYPES[elem_type]}"
    before = kernels.launch_counts()
    Ye = kernels.apply_generic(x, c["conn_T"], c["phi"], JxW, dphi, st)
    ref = kernels.apply_generic_plain(x, c["conn_T"], c["phi"], JxW, dphi,
                                      st)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert Ye.shape == ref.shape and rel(Ye, ref) < tol
    assert after[inst] == before[inst] + 1
    assert (after[f"apply_generic_{tag}"]
            == before[f"apply_generic_{tag}"] + 1)


@pytest.mark.parametrize("elem_type", list(NEW_TYPES))
def test_gather_interp_generic_new_instances_match_plain(cuda, elem_type):
    """K8 at PYRAMID5, PRISM6, TET10, QUAD4, QUAD8, QUAD9, HEX20 and
    HEX27, within 1e-13 of its plain version."""
    c = _elem_case(cuda, elem_type)
    inst = f"gather_interp_generic_f64:{NEW_TYPES[elem_type]}"
    before = kernels.launch_counts()[inst]
    out = kernels.gather_interp_generic(c["x"], c["conn_T"], c["phi"],
                                        c["dphi"])
    ref = kernels.gather_interp_generic_plain(c["x"], c["conn_T"], c["phi"],
                                              c["dphi"])
    torch.cuda.synchronize()
    assert all(rel(o, r) < 1e-13 for o, r in zip(out, ref))
    assert kernels.launch_counts()[inst] == before + 1


TILE_E = 32  # csrc/gather_interp_generic.cu kTileE: elements a K8 tile


def _tile_edge_case(dev, elem_type):
    """box_hex_mesh(5, 5, 3) raised to elem_type: 75 elements, three of
    K8's tiles with a ragged last one; the elements shuffled, so node ids
    are not monotone in e; the nodes jittered."""
    m = box_hex_mesh(5, 5, 3)
    coords, conn = elevate_hex(m.coords, m.connectivity,
                               elem_type == "HEX27")
    rng = np.random.default_rng(18)
    conn = conn[rng.permutation(len(conn))]
    coords = coords + 0.02 * rng.standard_normal(coords.shape)
    phi, _, dphi = geometry_factors(torch.as_tensor(coords, device=dev),
                                    torch.as_tensor(conn, device=dev),
                                    elem_type)
    conn_T = torch.as_tensor(np.ascontiguousarray(conn.T), device=dev)
    return phi, dphi.contiguous(), conn_T, len(coords), rng


@pytest.mark.parametrize("elem_type", ["HEX20", "HEX27"])
@pytest.mark.parametrize("n_vars", [1, V, kernels.MAX_V])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_gather_interp_generic_tile_edges_match_plain(cuda, elem_type,
                                                      n_vars, dtype, tol):
    """K8's HEX20 / HEX27 instances (a block a tile of elements, all q)
    over three tiles, the last ragged, on shuffled elements, at 1, 5 and
    8 species, f64 within 1e-13 and f32 within 1e-5 of the plain version;
    one launch counted under the variant and under the instance."""
    phi, dphi, conn_T, N, rng = _tile_edge_case(cuda, elem_type)
    E = conn_T.shape[1]
    assert E > 2 * TILE_E and E % TILE_E
    order = conn_T.min(0).values
    assert not bool((order[1:] >= order[:-1]).all())
    x = torch.as_tensor(rng.standard_normal((n_vars, N)), dtype=dtype,
                        device=cuda)
    dphi = dphi.to(dtype)
    variant = ("gather_interp_generic_"
               + ("f32" if dtype == torch.float32 else "f64"))
    inst = f"{variant}:{elem_type.lower()}"
    before = kernels.launch_counts()
    out = kernels.gather_interp_generic(x, conn_T, phi, dphi)
    ref = kernels.gather_interp_generic_plain(x, conn_T, phi, dphi)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    Q = phi.shape[0]
    assert out[0].shape == (n_vars, Q, E)
    assert out[1].shape == (n_vars, Q, 3, E)
    assert all(o.dtype == dtype and rel(o, r) < tol
               for o, r in zip(out, ref))
    assert after[inst] == before[inst] + 1
    assert after[variant] == before[variant] + 1


@pytest.mark.parametrize("mesh_kind", ["mixed", "tet10"])
def test_mixed_and_tet10_kernel_path_matches_plain_path(cuda, mesh_kind):
    """3 PIHNA steps on box_mixed_mesh(6,4,4) (HEX8, PYRAMID5, TET4) and
    on a TET10 box, through the kernels and through the plain versions,
    mixed precision, each from a common state; every kernel of the path
    launched."""
    b30 = ((0, 30.0),) * 3
    if mesh_kind == "mixed":
        mesh = box_mixed_mesh(6, 4, 4, bounds=b30)
        make = MixedTransientRDCSystem
        want = ["gather_interp_affine_f64", "rhs_affine_f64",
                "apply_affine_f32", "apply_affine_f64",
                "gather_interp_generic_f64:hex8",
                "gather_interp_generic_f64:pyramid5",
                "apply_generic_f64:hex8", "apply_generic_f64:pyramid5",
                "apply_generic_f32:pyramid5", "restrict_f64"]
    else:
        mesh = tet4_to_tet10(box_tet_mesh(3, 3, 3, bounds=b30))
        make = TransientRDCSystem
        want = ["gather_interp_generic_f64:tet10", "apply_generic_f64:tet10",
                "apply_generic_f32:tet10", "restrict_f64"]
    p = default_params()
    Kk = 2.39e5
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500 / Kk, necrosis_h=200 / Kk, necrosis_v=300 / Kk,
             produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82,
             switch_h2n=0.5, diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0,
             taxis_h=4e-5, diffuse_v=0.5, taxis_v=1e-4, produce_v=10.0,
             secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, uptake_a_v=1e-3,
             decay_a=5678.4)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(0)
    u0 = np.abs(rng.random((mesh.n_nodes, 5))) * np.array(
        [1., 100., 50., 500., 1e-10])
    a = make(mesh, 5, pihna_blocks, rtol=1e-12, precision="mixed",
             device=cuda)
    b = make(mesh, 5, pihna_blocks, rtol=1e-12, precision="mixed",
             device=cuda, ops=kernels.PLAIN_OPS)
    kernels.reset_launch_counts()
    sa = a.initial_state(u0)
    for _ in range(3):
        sb, _, _ = b.step(sa, params=p)
        sa, _, res = a.step(sa, params=p)
        assert float(res) <= 1e-12
        ua, ub = sa["u"].cpu().numpy(), sb["u"].cpu().numpy()
        assert np.linalg.norm(ua - ub) / np.linalg.norm(ub) < 1e-10
    n = kernels.launch_counts()
    assert all(n[k] > 0 for k in want), {k: n[k] for k in want}


def _pihna_live_params():
    p = default_params()
    Kk = 2.39e5
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500 / Kk, necrosis_h=200 / Kk, necrosis_v=300 / Kk,
             produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82,
             switch_h2n=0.5, diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0,
             taxis_h=4e-5, diffuse_v=0.5, taxis_v=1e-4, produce_v=10.0,
             secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, uptake_a_v=1e-3,
             decay_a=5678.4)
    return {k: float(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_affine_tri3_instances_match_plain(cuda, dtype, tol):
    """K1, K2 and K3 at TRI3's (K, Q) = (3, 4), each launch counted under
    the instance; an affine (K, Q) with no instance raises."""
    m = box_tri_mesh(9, 7, bounds=((0, 2.0), (0, 3.0)))
    rng = np.random.default_rng(13)
    coords = m.coords.copy()
    coords[:, :2] += 0.02 * rng.standard_normal((m.n_nodes, 2))
    phi, JxW, dphi = geometry_factors(torch.as_tensor(coords, device=cuda),
                                      torch.as_tensor(m.connectivity,
                                                      device=cuda), "TRI3")
    Q, E = JxW.shape
    on = lambda v, w: (v + 2 * w) % 3 != 1
    blk = lambda tail, s: [[rng.standard_normal(tail) if on(v, w + s)
                            else 0.0 for w in range(V)] for v in range(V)]
    blocks = ([rng.standard_normal((Q, E)) for _ in range(V)],
              [rng.standard_normal((Q, 3, E)) if v % 2 else 0.0
               for v in range(V)],
              blk((Q, E), 0), blk((Q, 3, E), 1), blk((Q, E), 2))
    conn_T = torch.as_tensor(np.ascontiguousarray(m.connectivity.T),
                             device=cuda)
    x = torch.as_tensor(rng.standard_normal((V, m.n_nodes)), device=cuda)
    dphi0 = dphi[0].contiguous()
    before = kernels.launch_counts()
    if dtype == torch.float64:
        wfb = blocks_from_numpy(*blocks, cuda)
        out = kernels.gather_interp_affine(x, conn_T, phi, dphi0)
        ref = kernels.gather_interp_affine_plain(x, conn_T, phi, dphi0)
        assert all(rel(o, r) < tol for o, r in zip(out, ref))
        rhs = kernels.stack_rhs(wfb)
        Fe = kernels.rhs_affine(rhs, JxW, phi, dphi0)
        assert rel(Fe, kernels.rhs_affine_plain(rhs, JxW, phi, dphi0)) < tol
    wfb = blocks_from_numpy(*blocks, cuda, dtype=dtype)
    J, d0, xx = JxW.to(dtype), dphi0.to(dtype), x.to(dtype)
    st = kernels.stack_apply(wfb, weakform.diffusion_presum(wfb, J))
    Ye = kernels.apply_affine(xx, conn_T, phi, J, d0, st)
    torch.cuda.synchronize()
    assert rel(Ye, kernels.apply_affine_plain(xx, conn_T, phi, J, d0,
                                              st)) < tol
    tag = "f32" if dtype == torch.float32 else "f64"
    after = kernels.launch_counts()
    names = [f"apply_affine_{tag}:tri3"] + (
        ["gather_interp_affine_f64:tri3", "rhs_affine_f64:tri3"]
        if dtype == torch.float64 else [])
    assert all(after[n] == before[n] + 1 for n in names)
    with pytest.raises(ValueError, match="no kernel for K=3, Q=5"):
        kernels.gather_interp_affine(x, conn_T, np.ones((5, 3)), dphi0)


def _slice6_mesh(kind):
    b = ((0, 30.0), (0, 30.0))
    if kind == "TRI3":
        return box_tri_mesh(6, 5, bounds=b)
    if kind == "QUAD9":
        q = box_quad_mesh(5, 4, bounds=b)
        return Mesh(*elevate_quad(q.coords, q.connectivity, True), "QUAD9")
    h = box_hex_mesh(2, 2, 2, bounds=b + ((0, 30.0),))
    return Mesh(*elevate_hex(h.coords, h.connectivity, True), "HEX27")


@pytest.mark.parametrize("kind", ["TRI3", "QUAD9", "HEX27"])
def test_slice6_kernel_path_matches_plain_path(cuda, kind):
    """3 PIHNA steps on TRI3, QUAD9 and HEX27 through the kernels and the
    plain versions, mixed precision, each from a common state; every
    kernel of the path launched."""
    mesh = _slice6_mesh(kind)
    if kind == "TRI3":
        want = ["gather_interp_affine_f64:tri3", "rhs_affine_f64:tri3",
                "apply_affine_f32:tri3", "apply_affine_f64:tri3"]
    else:
        e = kind.lower()
        want = [f"gather_interp_generic_f64:{e}", f"apply_generic_f64:{e}",
                f"apply_generic_f32:{e}"]
    p = _pihna_live_params()
    rng = np.random.default_rng(0)
    u0 = np.abs(rng.random((mesh.n_nodes, 5))) * np.array(
        [1., 100., 50., 500., 1e-10])
    a = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=1e-12,
                           precision="mixed", device=cuda)
    b = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=1e-12,
                           precision="mixed", device=cuda,
                           ops=kernels.PLAIN_OPS)
    kernels.reset_launch_counts()
    sa = a.initial_state(u0)
    for _ in range(3):
        sb, _, _ = b.step(sa, params=p)
        sa, _, res = a.step(sa, params=p)
        assert float(res) <= 1e-12
        ua, ub = sa["u"].cpu().numpy(), sb["u"].cpu().numpy()
        assert np.linalg.norm(ua - ub) / np.linalg.norm(ub) < 1e-10
    n = kernels.launch_counts()
    assert all(n[k] > 0 for k in want + ["restrict_f64"]), n


def test_dense_path_kernels_match_plain(cuda):
    """The dense path (physics=pihna_physics) on a TET4 box: 2 mixed-
    precision steps and `assemble` through K1 and K4 against the plain
    versions."""
    mesh = box_tet_mesh(4, 4, 3, bounds=((0, 30.0),) * 3)
    p = _pihna_live_params()
    rng = np.random.default_rng(1)
    u0 = np.abs(rng.random((mesh.n_nodes, 5))) * np.array(
        [1., 100., 50., 500., 1e-10])
    a, b = (TransientRDCSystem(mesh, 5, physics=pihna_physics, rtol=1e-12,
                               precision="mixed", device=cuda, ops=ops)
            for ops in (kernels.KERNEL_OPS, kernels.PLAIN_OPS))
    kernels.reset_launch_counts()
    sa = a.initial_state(u0)
    for _ in range(2):
        sb, _, _ = b.step(sa, params=p)
        sa, _, res = a.step(sa, params=p)
        assert float(res) <= 1e-12
        assert rel(sa["u"], sb["u"]) < 1e-10
    n = kernels.launch_counts()
    assert n["gather_interp_affine_f64"] > 0 and n["restrict_f32"] > 0
    u_T = sa["u"].T.contiguous()
    (va, ba), (vb, bb) = (s.assemble(u_T, {}, p) for s in (a, b))
    assert rel(va, vb) < 1e-13 and rel(ba, bb) < 1e-13


# ----------------------------------------------------------------------
# the f32 instances of K1, K2 and K8 (the dtype=float32 mode)
# ----------------------------------------------------------------------
F32_BAR = 1e-5


def _affine_case(dev, elem_type):
    """Seeded f32 inputs of K1 and K2 on a jittered TET4 or TRI3 box."""
    if elem_type == "TET4":
        m = box_tet_mesh(5, 4, 3, bounds=((0, 2.0), (0, 3.0), (0, 2.5)))
    else:
        m = box_tri_mesh(9, 7, bounds=((0, 2.0), (0, 3.0)))
    rng = np.random.default_rng(17)
    dim = 3 if elem_type == "TET4" else 2  # TRI3 stays in its plane
    coords = m.coords.copy()
    coords[:, :dim] += 0.02 * rng.standard_normal((m.n_nodes, dim))
    phi, JxW, dphi = geometry_factors(torch.as_tensor(coords, device=dev),
                                      torch.as_tensor(m.connectivity,
                                                      device=dev), elem_type)
    Q, E = JxW.shape
    blocks = ([rng.standard_normal((Q, E)) if v != 2 else 0.0
               for v in range(V)],
              [rng.standard_normal((Q, 3, E)) if v % 2 else 0.0
               for v in range(V)], [[0.0] * V] * V, [[0.0] * V] * V,
              [[0.0] * V] * V)
    f32 = torch.float32
    return dict(
        phi=phi, JxW=JxW.to(f32), dphi0=dphi[0].to(f32).contiguous(),
        wfb=blocks_from_numpy(*blocks, dev, dtype=f32),
        conn_T=torch.as_tensor(np.ascontiguousarray(m.connectivity.T),
                               device=dev),
        x=torch.as_tensor(rng.standard_normal((V, m.n_nodes)), dtype=f32,
                          device=dev))


@pytest.mark.parametrize("elem_type", ["TET4", "TRI3"])
def test_affine_f32_instances_match_plain(cuda, elem_type):
    """K1 f32 and K2 f32 at TET4 (4, 5) and TRI3 (3, 4) within 1e-5 of
    their plain f32 versions, f32 out, each launch counted under the f32
    variant and its instance; an f64 table under f32 values raises."""
    c = _affine_case(cuda, elem_type)
    tag = "tet4" if elem_type == "TET4" else "tri3"
    names = [f"gather_interp_affine_f32:{tag}", f"rhs_affine_f32:{tag}",
             "gather_interp_affine_f32", "rhs_affine_f32"]
    before = kernels.launch_counts()
    out = kernels.gather_interp_affine(c["x"], c["conn_T"], c["phi"],
                                       c["dphi0"])
    ref = kernels.gather_interp_affine_plain(c["x"], c["conn_T"], c["phi"],
                                             c["dphi0"])
    rhs = kernels.stack_rhs(c["wfb"])
    Fe = kernels.rhs_affine(rhs, c["JxW"], c["phi"], c["dphi0"])
    Fr = kernels.rhs_affine_plain(rhs, c["JxW"], c["phi"], c["dphi0"])
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert all(o.dtype == torch.float32 for o in out + (Fe,))
    assert all(rel(o, r) < F32_BAR for o, r in zip(out, ref))
    assert rel(Fe, Fr) < F32_BAR and not Fe[2].any()
    assert all(after[n] == before[n] + 1 for n in names)
    assert after["gather_interp_affine_f64"] == before[
        "gather_interp_affine_f64"]
    with pytest.raises(TypeError):
        kernels.gather_interp_affine(c["x"], c["conn_T"], c["phi"],
                                     c["dphi0"].double())
    with pytest.raises(TypeError):
        kernels.rhs_affine(rhs, c["JxW"].double(), c["phi"],
                           c["dphi0"].double())
    with pytest.raises(TypeError):
        kernels.gather_interp_affine(c["x"].half(), c["conn_T"], c["phi"],
                                     c["dphi0"].half())


GENERIC_TYPES = {"HEX8": "hex8", **NEW_TYPES}


@pytest.mark.parametrize("elem_type", list(GENERIC_TYPES))
def test_gather_interp_generic_f32_instances_match_plain(cuda, elem_type):
    """K8 f32 at every GENERIC_KQ instance (HEX8, PYRAMID5, PRISM6, TET10,
    QUAD4, QUAD8, QUAD9, HEX20, HEX27; at HEX20 and HEX27 the thread per
    (element, q) path, also at its 8 species) within 1e-5 of its plain f32
    version, counted under the f32 variant and the instance."""
    for n_vars in ((V, kernels.MAX_V) if elem_type.startswith("HEX2")
                   else (V,)):
        c = _elem_case(cuda, elem_type, n_vars)
        f32 = torch.float32
        x, dphi = c["x"].to(f32), c["dphi"].to(f32)
        inst = f"gather_interp_generic_f32:{GENERIC_TYPES[elem_type]}"
        before = kernels.launch_counts()
        out = kernels.gather_interp_generic(x, c["conn_T"], c["phi"], dphi)
        ref = kernels.gather_interp_generic_plain(x, c["conn_T"], c["phi"],
                                                  dphi)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert all(o.dtype == f32 and o.shape == r.shape
                   for o, r in zip(out, ref))
        assert all(rel(o, r) < F32_BAR for o, r in zip(out, ref))
        assert after[inst] == before[inst] + 1
        assert (after["gather_interp_generic_f32"]
                == before["gather_interp_generic_f32"] + 1)


@pytest.mark.parametrize("kind", ["TET4", "HEX8", "MIXED"])
def test_f32_system_kernel_path_matches_plain_path(cuda, kind):
    """3 PIHNA steps of an f32 system (precision "mixed", which f32 runs
    as the plain solve) through the kernels and through the plain
    versions from a common state, within 1e-5 per step; only f32
    instances launched."""
    b30 = ((0, 30.0),) * 3
    mesh = {"TET4": lambda: box_tet_mesh(4, 4, 3, bounds=b30),
            "HEX8": lambda: box_hex_mesh(4, 3, 3, bounds=b30),
            "MIXED": lambda: box_mixed_mesh(6, 4, 4, bounds=b30)}[kind]()
    make = MixedTransientRDCSystem if kind == "MIXED" else TransientRDCSystem
    p = _pihna_live_params()
    rng = np.random.default_rng(2)
    u0 = np.abs(rng.random((mesh.n_nodes, 5))) * np.array(
        [1., 100., 50., 500., 1e-10])
    a, b = (make(mesh, 5, pihna_blocks, rtol=3e-11, precision="mixed",
                 dtype=torch.float32, device=cuda, ops=ops)
            for ops in (kernels.KERNEL_OPS, kernels.PLAIN_OPS))
    kernels.reset_launch_counts()
    sa = a.initial_state(u0)
    for _ in range(3):
        sb, _, _ = b.step(sa, params=p)
        sa, _, res = a.step(sa, params=p)
        assert sa["u"].dtype == torch.float32 and float(res) <= 1e-6
        assert rel(sa["u"], sb["u"]) < F32_BAR
    n = kernels.launch_counts()
    want = {"TET4": kernels.TRANSIENT_F32_VARIANTS,
            "HEX8": kernels.GENERIC_F32_VARIANTS,
            "MIXED": kernels.TRANSIENT_F32_VARIANTS
            + kernels.GENERIC_F32_VARIANTS}[kind]
    assert all(n[k] > 0 for k in want), n
    assert not any(n[k] for k in n if "f64" in k), n


@pytest.mark.parametrize("kind", ["TET4", "HEX8", "TET10", "QUAD4",
                                  "MIXED"])
def test_halo_kernel_path_matches_plain_path(cuda, kind):
    """The multi-device halo system on 3 shards of the card (every shard
    on cuda:0 with one card): 3 steps through the kernels against 3
    through the plain versions within 1e-10, and against the
    single-device system (f64) within 1e-8; K4 launched for both the
    restriction and the reverse add."""
    from rdcfes_tpu_torch.parallel import HaloShardedSystem

    mesh = {"TET4": lambda: box_tet_mesh(6, 6, 6),
            "HEX8": lambda: box_hex_mesh(5, 5, 5),
            "TET10": lambda: tet4_to_tet10(box_tet_mesh(4, 4, 4)),
            "QUAD4": lambda: box_quad_mesh(12, 12),
            "MIXED": lambda: box_mixed_mesh(6, 4, 4)}[kind]()
    Kk = 2.39e5
    p = default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500 / Kk, necrosis_h=200 / Kk, necrosis_v=300 / Kk,
             produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82,
             switch_h2n=0.5, diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0,
             diffuse_v=0.2, produce_v=10.0, secrete_a_c=2.77e-13,
             secrete_a_h=5.22e-10, decay_a=5678.4)
    p = {k: float(v) for k, v in p.items()}
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 2000 * np.exp(-r2 / 3)
    u0[:, 2] = 500 * np.exp(-r2 / 2.5)
    u0[:, 3] = 7200 * np.exp(-r2 / 20)
    u0[:, 4] = 1e-10
    hk = HaloShardedSystem(mesh, 5, 3, pihna_blocks, rtol=1e-12,
                           device=cuda)
    hp = HaloShardedSystem(mesh, 5, 3, pihna_blocks, rtol=1e-12,
                           device=cuda, ops=kernels.PLAIN_OPS)
    one = (MixedTransientRDCSystem if kind == "MIXED" else
           TransientRDCSystem)(mesh, 5, pihna_blocks, rtol=1e-12,
                               device=cuda)
    assert all(sh.device.type == "cuda" for sh in hk.shards)
    assert {sh.device.index for sh in hk.shards} == set(
        range(min(3, torch.cuda.device_count())))
    a, b, c = hk.initial_state(u0), hp.initial_state(u0), one.initial_state(
        u0)
    kernels.reset_launch_counts()
    for _ in range(3):
        a, _, _ = hk.step(a, params=p)
        b, _, _ = hp.step(b, params=p)
        c, _, _ = one.step(c, params=p)
        ua = torch.as_tensor(hk.gather(a["u"]))
        assert rel(ua, torch.as_tensor(hp.gather(b["u"]))) <= 1e-10
        assert rel(ua, c["u"]) <= 1e-8
    counts = kernels.launch_counts()
    affine = ("gather_interp_affine_f64", "rhs_affine_f64",
              "apply_affine_f64")
    generic = lambda e: (f"gather_interp_generic_f64:{e}",
                         f"apply_generic_f64:{e}")
    names = {"TET4": affine, "HEX8": generic("hex8"),
             "TET10": generic("tet10"), "QUAD4": generic("quad4"),
             "MIXED": affine + generic("hex8") + generic("pyramid5")}[kind]
    assert all(counts[n] > 0 for n in names + ("restrict_f64",)), counts
    # K4 over one shard's rev_gather against its plain version
    sh = hk.shards[0]
    flat = torch.rand((5, hk.plan.Gtot), dtype=torch.float64, device=cuda)
    assert rel(kernels.restrict(flat, sh.rev_gather),
               kernels.restrict_plain(flat, sh.rev_gather)) <= 1e-13


def _hcc_moving_case(mesh):
    """(plain-float HCC params, u0 (N, 3), moved coords (N, 3))."""
    from rdcfes_tpu_torch.models.hcc import default_params as hcc_defaults

    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    s = float(np.ptp(mesh.coords))
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 0.3 * np.exp(-r2 / (0.05 * s * s))
    u0[:, 2] = 0.1 * np.exp(-r2 / (0.08 * s * s))
    p = hcc_defaults()
    p.update(dt=0.05, diffuse_c=1e-3 * s * s, produce_c=0.2,
             cells_max_capacity=1.0)
    coords = mesh.coords + 0.03 * s * np.sin(mesh.coords * 3.0 / s)
    return {k: float(v) for k, v in p.items()}, u0, coords


@pytest.mark.parametrize("kind", ["TET4", "HEX8", "MIXED"])
def test_moving_halo_kernel_path_matches_plain_path(cuda, kind):
    """The moving mesh on 4 shards of the card: 3 HCC steps at moved
    coords through the kernels against 3 through the plain versions
    within 1e-10, and against the single-device moving system within
    1e-8; each instance's launches are the step's own count: per step
    and shard holding a block, one K1/K8 and (TET4) one K2 launch, one
    K3/K6 per matvec (1 + 2 per BiCGStab iteration), and K4 four times
    (b, the diagonal, their reverse adds) plus twice per matvec."""
    from rdcfes_tpu_torch.models.hcc import hcc_blocks
    from rdcfes_tpu_torch.parallel import HaloShardedSystem

    mesh = {"TET4": lambda: box_tet_mesh(8, 8, 8),
            "HEX8": lambda: box_hex_mesh(6, 6, 6),
            "MIXED": lambda: box_mixed_mesh(6, 4, 4)}[kind]()
    p, u0, coords = _hcc_moving_case(mesh)
    D = 4
    kw = dict(rtol=1e-12, moving_mesh=True, device=cuda)
    hk = HaloShardedSystem(mesh, 3, D, hcc_blocks, **kw)
    hp = HaloShardedSystem(mesh, 3, D, hcc_blocks, ops=kernels.PLAIN_OPS,
                           **kw)
    one = (MixedTransientRDCSystem if kind == "MIXED" else
           TransientRDCSystem)(mesh, 3, hcc_blocks, **kw)
    xt = torch.as_tensor(coords, device=cuda)
    a, b, c = (s.initial_state(u0) for s in (hk, hp, one))
    its = []
    kernels.reset_launch_counts()
    for _ in range(3):
        a, it, _ = hk.step(a, params=p, coords=xt)
        its.append(int(it))
    counts = kernels.launch_counts()
    for _ in range(3):
        b, _, _ = hp.step(b, params=p, coords=xt)
        c, _, _ = one.step(c, params=p, coords=xt)
    ua = torch.as_tensor(hk.gather(a["u"]))
    assert rel(ua, torch.as_tensor(hp.gather(b["u"]))) <= 1e-10
    assert rel(ua, c["u"]) <= 1e-8
    mv = sum(1 + 2 * i for i in its)
    held = {}  # instance -> shards holding a block of it
    for sh in hk.shards:
        for _, blk, _ in sh.parts:
            name = (["gather_interp_affine_f64", "rhs_affine_f64"],
                    "apply_affine_f64") if blk.affine else (
                [f"gather_interp_generic_f64:{blk.elem_type.lower()}"],
                f"apply_generic_f64:{blk.elem_type.lower()}")
            for n in name[0]:
                held[n] = held.get(n, 0) + 3
            held[name[1]] = held.get(name[1], 0) + mv
    busy = sum(1 for sh in hk.shards if sh.parts)
    held["restrict_f64"] = 4 * 3 * busy + 2 * mv * busy
    assert {k: counts.get(k, 0) for k in held} == held, counts


@pytest.mark.parametrize("kind", ["HEX8", "MIXED"])
def test_solid_halo_kernel_path_matches_plain_path(cuda, kind):
    """The solid's halo Newton on 4 shards of the card: one load step
    through K4 against the plain versions within 1e-10, and against the
    single-device f64 solve within 1e-8 (MIXED 1e-6); K5 is not on the
    path, and K4's launches are the Newton's own count (per assembly and
    shard one launch for the residual and one for the diagonal over the
    elements and over each face group it holds, per matvec and trial one
    plus one a face group, and a reverse add each on every shard)."""
    mesh = {"HEX8": lambda: box_hex_mesh(6, 6, 6),
            "MIXED": lambda: box_mixed_mesh(6, 4, 4)}[kind]()
    kw = dict(materials={0: {"young": 1.0e3, "poisson": 0.3}},
              bcs={0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)},
              penalty=1.0e6, device=cuda,
              newton=NewtonOptions(max_nonlinear_iterations=20,
                                   relative_residual_tolerance=1e-8))
    D = 4
    sk = SolidSystem(mesh, device_mesh=D, **kw)
    sp = SolidSystem(mesh, device_mesh=D, ops=kernels.PLAIN_OPS, **kw)
    one = SolidSystem(mesh, ops=kernels.PLAIN_OPS, **kw)
    calls = {"assemble": 0, "residual_norm": 0}
    halo = sk._halo
    for name in calls:
        orig = getattr(halo, name)
        setattr(halo, name, lambda *a, _o=orig, _n=name: (
            calls.__setitem__(_n, calls[_n] + 1), _o(*a))[1])
    kernels.reset_launch_counts()
    rk = sk.run_solver(sk.initial_positions(), 0.5)
    counts = kernels.launch_counts()
    rp = sp.run_solver(sp.initial_positions(), 0.5)
    r1 = one.run_solver(one.initial_positions(), 0.5)
    assert rk.converged and rp.converged and r1.converged
    assert rk.iters == rp.iters
    assert rel(rk.x, rp.x) <= 1e-10
    assert rel(rk.x, r1.x) <= (1e-6 if kind == "MIXED" else 1e-8)
    assert not any(counts.get(k, 0) for k in counts if "ell_matvec" in k)
    per = [(1 if sh.node_gather is not None else 0) + len(sh.faces)
           for sh in halo.shards]
    assemble = 2 * sum(per) + 2 * D
    apply = sum(per) + D
    mv = rk.iters + 2 * rk.linear_iters  # one r0 product per solve
    want = (calls["assemble"] * assemble
            + (mv + calls["residual_norm"]) * apply)
    assert calls["assemble"] == rk.iters + 1
    assert counts.get("restrict_f64", 0) == want, counts


@pytest.mark.parametrize("kind", ["TET4", "HEX8", "QUAD4"])
def test_sharded_kernel_path_matches_plain_path(cuda, kind):
    """The replicated-iterate system (parallel.sharding) on 3 shards of
    the card: 2 dense PIHNA steps through the kernels (K1 or K8, K4)
    against 2 through the plain versions within 1e-10, and against the
    single-device dense system (f64) within 1e-8 a step; the gather and
    K4 launched."""
    from rdcfes_tpu_torch.parallel import ShardedTransientSystem

    mesh = {"TET4": lambda: box_tet_mesh(6, 6, 6),
            "HEX8": lambda: box_hex_mesh(5, 5, 5),
            "QUAD4": lambda: box_quad_mesh(12, 12)}[kind]()
    p = {k: float(v) for k, v in _pihna_live_params().items()}
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 2000 * np.exp(-r2 / 3)
    u0[:, 3] = 7200 * np.exp(-r2 / 20)
    u0[:, 4] = 1e-10
    sk = ShardedTransientSystem(mesh, 5, pihna_physics, 3, device=cuda)
    sp = ShardedTransientSystem(mesh, 5, pihna_physics, 3, device=cuda,
                                ops=kernels.PLAIN_OPS)
    one = TransientRDCSystem(mesh, 5, physics=pihna_physics, rtol=1e-12,
                             precision="f64", device=cuda)
    assert {sh.device.index for sh in sk.shards} == set(
        range(min(3, torch.cuda.device_count())))
    a, b, c = sk.initial_state(u0), sp.initial_state(u0), one.initial_state(
        u0)
    gather = {"TET4": "gather_interp_affine_f64:tet4",
              "HEX8": "gather_interp_generic_f64:hex8",
              "QUAD4": "gather_interp_generic_f64:quad4"}[kind]
    for _ in range(2):
        kernels.reset_launch_counts()
        a, its, ra = sk.step(a, params=p)
        counts = kernels.launch_counts()
        # one gather a shard; K4 for b, the diagonal and 2 matvecs an
        # iteration, on every shard
        assert counts[gather] == 3, counts
        assert counts["restrict_f64"] == 3 * (2 + 2 * its + 1), counts
        b, _, _ = sp.step(b, params=p)
        c, _, _ = one.step(c, params=p)
        assert float(ra) <= 1e-12
        assert rel(a, b) <= 1e-10 and rel(a, c["u"]) <= 1e-8


def test_bcsr_and_scatter_assembly_on_the_card(cuda):
    """bcsr_matvec, assemble_matrix and assemble_vector through K4 against
    the plain versions (1e-13), and solve_bcsr through them against the
    plain solve (1e-10); K4 launched, the CUDA tensors never sent to a
    plain version."""
    from rdcfes_tpu_torch.solvers.krylov import solve_bcsr

    mesh = box_tet_mesh(6, 6, 6)
    N, E = mesh.n_nodes, mesh.n_elems
    sp = assembly.build_sparsity(mesh.connectivity, N)
    rng = np.random.default_rng(19)
    t = lambda a: torch.as_tensor(a, device=cuda)
    values, x = t(rng.standard_normal((2, 3, sp.nnz))), t(
        rng.standard_normal((3, N)))
    Ke, Fe = t(rng.standard_normal((2, 3, 4, 4, E))), t(
        rng.standard_normal((2, 4, E)))
    slots, conn = sp.slots_flat_cf(), mesh.connectivity.T.reshape(-1)
    kernels.reset_launch_counts()
    for fn in (lambda o: bcsr.bcsr_matvec(values, sp.rows, sp.cols, x, N,
                                          ops=o),
               lambda o: assembly.assemble_matrix(Ke, slots, sp.nnz, ops=o),
               lambda o: assembly.assemble_vector(Fe, conn, N, ops=o)):
        out = fn(None)
        assert out.is_cuda and rel(out, fn(kernels.PLAIN_OPS)) <= 1e-13
    assert kernels.launch_counts()["restrict_f64"] == 3
    # an SPD system: element blocks R R^T + I assembled
    R = rng.standard_normal((E, 8, 8)) * 0.3
    Me = R @ R.transpose(0, 2, 1) + np.eye(8)[None]
    A = assembly.assemble_matrix(
        t(Me.reshape(E, 2, 4, 2, 4).transpose(1, 3, 2, 4, 0)), slots, sp.nnz)
    b = t(rng.standard_normal((2, N)))
    got = solve_bcsr(A, sp, b, rtol=1e-12)
    want = solve_bcsr(A, sp, b, rtol=1e-12, ops=kernels.PLAIN_OPS)
    assert float(got.residual) <= 1e-12
    assert rel(got.x, want.x) <= 1e-10
