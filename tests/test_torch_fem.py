"""rdcfes_tpu_torch FEM layer against rdcfes_tpu on box_tet_mesh(3,3,3):
geometry, interpolation, the affine weak-form functions and the
restriction agree in f64 within 1e-13 relative (largest-entry scale; only
summation order may differ), with every C/D/E block live and with some
absent.  Each kernel wrapper's plain version equals the module function it
stands for; the kernels themselves run on a CUDA device only
(tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh

from rdcfes_tpu_torch.fem import assembly, geometry, kernels, weakform
from rdcfes_tpu_torch.utils.convert import blocks_from_numpy

V = 5
TOL = 1e-13


def rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pattern(kind, v, w):
    """'all': every block live; 'some': a fixed sparse subset."""
    return kind == "all" or (v + 2 * w) % 3 == 0


@pytest.fixture(scope="module")
def case():
    mesh = jax_box_tet_mesh(3, 3, 3, bounds=((0, 2.0), (0, 3.0), (0, 2.5)))
    phi, JxW, dphi = jgeo.geometry_factors(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.connectivity), "TET4")
    JxW, dphi = np.asarray(JxW), np.asarray(dphi)
    Q, K = phi.shape
    E = mesh.n_elems
    rng = np.random.default_rng(7)
    blocks = {}
    for kind in ("all", "some"):
        A = [rng.standard_normal((Q, E)) if v != 2 or kind == "all" else 0.0
             for v in range(V)]
        B = [rng.standard_normal((Q, 3, E)) if _pattern(kind, v, 1) else 0.0
             for v in range(V)]
        mk = lambda tail, s: [[rng.standard_normal(tail)
                               if _pattern(kind, v, w + s) else 0.0
                               for w in range(V)] for v in range(V)]
        blocks[kind] = (A, B, mk((Q, E), 0), mk((Q, 3, E), 1), mk((Q, E), 2))
    x = rng.standard_normal((V, mesh.n_nodes))
    ue = x[:, mesh.connectivity.T]
    return dict(mesh=mesh, phi=phi, JxW=JxW, dphi=dphi, blocks=blocks, x=x,
                ue=ue, rng=rng)


def _jax_blocks(A, B, C, D, E):
    f = lambda a: a if isinstance(a, float) else jnp.asarray(a)
    return jwf.WeakFormBlocks(
        A=tuple(f(a) for a in A), B=tuple(f(b) for b in B),
        C=tuple(tuple(f(c) for c in r) for r in C),
        D=tuple(tuple(f(d) for d in r) for r in D),
        E=tuple(tuple(f(e) for e in r) for r in E))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_geometry_factors_match(case):
    m = case["mesh"]
    phi, JxW, dphi = geometry.geometry_factors(
        _t(m.coords), torch.as_tensor(m.connectivity), "TET4")
    assert np.array_equal(phi, case["phi"])
    assert rel(JxW, case["JxW"]) < TOL
    assert rel(dphi, case["dphi"]) < TOL
    with pytest.raises(NotImplementedError):
        geometry.geometry_factors(_t(m.coords), torch.as_tensor(
            m.connectivity), "PRISM6")


def test_interpolate_ue_affine_matches(case):
    ref = jasm.interpolate_ue_affine(jnp.asarray(case["ue"]), case["phi"],
                                     jnp.asarray(case["dphi"]))
    out = assembly.interpolate_ue_affine(_t(case["ue"]), case["phi"],
                                         _t(case["dphi"]))
    for o, r in zip(out, ref):
        assert rel(o, r) < TOL


@pytest.mark.parametrize("kind", ["all", "some"])
def test_block_rhs_affine_matches(case, kind):
    blk = case["blocks"][kind]
    ref = jwf.block_rhs_affine(_jax_blocks(*blk), case["phi"],
                               jnp.asarray(case["JxW"]),
                               jnp.asarray(case["dphi"]))
    out = weakform.block_rhs_affine(blocks_from_numpy(*blk, "cpu"),
                                    case["phi"], _t(case["JxW"]),
                                    _t(case["dphi"]))
    assert rel(out, ref) < TOL
    if kind == "some":  # species 2 has neither A nor B: genuine zeros
        assert not np.asarray(ref)[2].any() and not out[2].any()


@pytest.mark.parametrize("kind", ["all", "some"])
def test_diffusion_presum_and_qp_apply_affine_match(case, kind):
    blk = case["blocks"][kind]
    jw = _jax_blocks(*blk)
    tw = blocks_from_numpy(*blk, "cpu")
    jE = jwf.diffusion_presum(jw, jnp.asarray(case["JxW"]))
    tE = weakform.diffusion_presum(tw, _t(case["JxW"]))
    for v in range(V):
        for w in range(V):
            if isinstance(jE[v][w], float):
                assert tE[v][w] == 0.0 and isinstance(tE[v][w], float)
            else:
                assert rel(tE[v][w], jE[v][w]) < TOL
    x_qp, gx = jasm.interpolate_ue_affine(jnp.asarray(case["ue"]),
                                          case["phi"],
                                          jnp.asarray(case["dphi"]))
    ref = jwf.qp_apply_affine(jw, jE, case["phi"], jnp.asarray(case["JxW"]),
                              jnp.asarray(case["dphi"]), x_qp, gx)
    out = weakform.qp_apply_affine(tw, tE, case["phi"], _t(case["JxW"]),
                                   _t(case["dphi"]), _t(x_qp), _t(gx))
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("kind", ["all", "some"])
def test_block_diag_affine_matches(case, kind):
    blk = case["blocks"][kind]
    ref = jwf.block_diag_affine(_jax_blocks(*blk), case["phi"],
                                jnp.asarray(case["JxW"]),
                                jnp.asarray(case["dphi"]))
    out = weakform.block_diag_affine(blocks_from_numpy(*blk, "cpu"),
                                     case["phi"], _t(case["JxW"]),
                                     _t(case["dphi"]))
    assert out.shape == (V, V, 4, case["mesh"].n_elems)
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("W", [V, V * V])
def test_restrict_matches(case, W):
    m = case["mesh"]
    sp = assembly.build_sparsity(m.connectivity, m.n_nodes)
    _, ng = assembly.gather_tables(sp, m.connectivity)
    Fe = case["rng"].standard_normal((W, 4, m.n_elems))
    ref = jasm.assemble_vector_gather(jnp.asarray(Fe), jnp.asarray(ng))
    out = assembly.restrict(_t(Fe).reshape(W, -1), torch.as_tensor(ng))
    # same gathers, same order: equal bit for bit
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["all", "some"])
def test_plain_versions_equal_module_functions(case, kind, dtype):
    m = case["mesh"]
    blk = case["blocks"][kind]
    wfb = blocks_from_numpy(*blk, "cpu", dtype=dtype)
    JxW, dphi = _t(case["JxW"], dtype), _t(case["dphi"], dtype)
    conn_T = torch.as_tensor(np.ascontiguousarray(m.connectivity.T))
    x = _t(case["x"], dtype)
    phi = case["phi"]

    uq, g = kernels.gather_interp_affine_plain(x, conn_T, phi, dphi[0])
    ruq, rg = assembly.interpolate_ue_affine(x[:, conn_T], phi, dphi)
    assert torch.equal(uq, ruq) and torch.equal(g, rg)

    rhs = kernels.stack_rhs(wfb)
    assert torch.equal(kernels.rhs_affine_plain(rhs, JxW, phi, dphi[0]),
                       weakform.block_rhs_affine(wfb, phi, JxW, dphi))

    Epre = weakform.diffusion_presum(wfb, JxW)
    st = kernels.stack_apply(wfb, Epre)
    n_live = lambda b: sum(not isinstance(e, float) for r in b for e in r)
    assert (len(st.idxC), len(st.idxD), len(st.idxE)) == (
        n_live(wfb.C), n_live(wfb.D), n_live(wfb.E))
    Ye = kernels.apply_affine_plain(x, conn_T, phi, JxW, dphi[0], st)
    assert Ye.dtype == dtype
    assert torch.equal(Ye, weakform.qp_apply_affine(wfb, Epre, phi, JxW,
                                                    dphi, ruq, rg))

    assert kernels.restrict_plain is assembly.restrict
    # on CPU tensors every wrapper is its plain version
    assert torch.equal(kernels.gather_interp_affine(x, conn_T, phi,
                                                    dphi[0])[0], uq)
    assert torch.equal(kernels.rhs_affine(rhs, JxW, phi, dphi[0]),
                       kernels.rhs_affine_plain(rhs, JxW, phi, dphi[0]))
    assert torch.equal(kernels.apply_affine(x, conn_T, phi, JxW, dphi[0],
                                            st), Ye)


def test_wrappers_refuse_other_devices(case):
    x = torch.empty((V, 8), device="meta")
    with pytest.raises(ValueError):
        kernels.restrict(x, torch.empty((2, 8), dtype=torch.int32,
                                        device="meta"))
