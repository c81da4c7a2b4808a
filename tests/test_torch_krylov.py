"""rdcfes_tpu_torch Krylov layer: the block-Jacobi pieces match rdcfes_tpu,
BiCGStab and the mixed-precision refinement match a dense solve, and the
breakdown guard keeps the last iterate."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.solvers import krylov as jkrylov

from rdcfes_tpu_torch.solvers import krylov
from rdcfes_tpu_torch.systems.transient import refine_mixed


def _blocks(V=5, N=64, seed=0):
    """Diagonally dominant (V, V, N) blocks, as the CN diagonal is."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((V, V, N))
    D[np.arange(V), np.arange(V)] += 4.0 * V
    return D


@pytest.mark.parametrize("V", [1, 3, 5])
def test_small_block_inverse_matches(V):
    D = _blocks(V)
    out = krylov.small_block_inverse(torch.as_tensor(D)).numpy()
    ref = np.asarray(jkrylov.small_block_inverse(jnp.asarray(D),
                                                 pivot=False))
    assert np.abs(out - ref).max() <= 1e-14 * np.abs(ref).max()
    eye = np.einsum("vwn,wun->vun", D, out)
    assert np.allclose(eye, np.eye(V)[:, :, None], atol=1e-13)


def test_apply_block_jacobi_matches():
    D = _blocks()
    r = np.random.default_rng(1).standard_normal((5, 64))
    out = krylov.apply_block_jacobi(torch.as_tensor(D), torch.as_tensor(r))
    ref = jkrylov.apply_block_jacobi(jnp.asarray(D), jnp.asarray(r))
    assert np.allclose(out.numpy(), np.asarray(ref), rtol=1e-15, atol=1e-15)


def _system(n=40, seed=2):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    b = rng.standard_normal(n)
    return A, b


@pytest.mark.parametrize("precond", [False, True])
def test_bicgstab_matches_dense_solve(precond):
    A, b = _system()
    At = torch.as_tensor(A)
    mv = lambda x: At @ x
    M = ((lambda r: r / torch.as_tensor(np.diag(A).copy())) if precond
         else krylov._identity)
    res = krylov.bicgstab(mv, torch.as_tensor(b), M=M, rtol=1e-12,
                          maxiter=200)
    x = np.linalg.solve(A, b)
    assert 0 < res.iters < 200
    assert float(res.residual) <= 1e-12
    assert np.linalg.norm(res.x.numpy() - x) <= 1e-10 * np.linalg.norm(x)


def test_bicgstab_zero_rhs_and_breakdown():
    b = torch.zeros(6, dtype=torch.float64)
    res = krylov.bicgstab(lambda x: 2.0 * x, b)
    assert res.iters == 0 and not res.x.any()
    # A = 0: r_hat . v == 0 on the first iteration -> breakdown guard
    b = torch.ones(6, dtype=torch.float64)
    x0 = torch.full((6,), 0.5, dtype=torch.float64)
    res = krylov.bicgstab(lambda x: 0.0 * x, b, x0=x0, maxiter=30)
    assert res.iters == 30
    assert torch.equal(res.x, x0)
    assert float(res.residual) == 1.0


@pytest.mark.parametrize("adaptive", [True, False])
def test_refine_mixed_matches_dense_solve(adaptive):
    A, b = _system(seed=4)
    A64 = torch.as_tensor(A)
    A32 = A64.to(torch.float32)
    x_ref = np.linalg.solve(A, b)
    x0 = torch.as_tensor(x_ref + 1e-3 * np.random.default_rng(5)
                         .standard_normal(len(b)))
    x, iters, res = refine_mixed(lambda v: A32 @ v, lambda v: A64 @ v,
                                 torch.as_tensor(b), x0, 3e-11, 500,
                                 adaptive_tol=adaptive)
    assert x.dtype == torch.float64 and iters > 0
    assert float(res) <= 3e-11
    assert np.linalg.norm(x.numpy() - x_ref) <= 1e-9 * np.linalg.norm(x_ref)


def test_refine_mixed_f64_rescue():
    """An f32 operator too far from the f64 one (each pass leaves 2/3 of
    the residual) trips the stagnation exit after one refinement pass; only
    the f64 BiCGStab rescue can then meet the tolerance."""
    A, b = _system(seed=6)
    A64 = torch.as_tensor(A)
    A32 = (A64 * 3.0).to(torch.float32)
    x, _, res = refine_mixed(lambda v: A32 @ v, lambda v: A64 @ v,
                             torch.as_tensor(b),
                             torch.zeros(len(b), dtype=torch.float64), 1e-12,
                             500)
    assert float(res) <= 1e-12
    assert np.allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-9,
                       atol=1e-10)
