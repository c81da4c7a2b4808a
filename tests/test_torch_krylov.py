"""rdcfes_tpu_torch Krylov layer: the block-Jacobi pieces match rdcfes_tpu,
BiCGStab and the mixed-precision refinement match a dense solve, the
breakdown guard keeps the last iterate, and CG and restarted GMRES match
the reference's on a small seeded system (solution within 1e-10, the same
iteration counts: whole restart cycles for GMRES)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.solvers import krylov as jkrylov

from rdcfes_tpu_torch.solvers import krylov
from rdcfes_tpu_torch.systems.transient import refine_mixed

from tests.torch_helpers import quick_compile


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    """The reference's jit compiles, which dominate this file's time,
    without XLA's expensive passes (tests/torch_helpers.quick_compile)."""
    with quick_compile():
        yield


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


def _spd(n=40, seed=8):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)) / np.sqrt(n)
    return B @ B.T + 2.0 * np.eye(n), rng.standard_normal(n)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_reference(precond):
    A, b = _spd()
    d = np.diag(A).copy()
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    res = krylov.cg(lambda x: At @ x, torch.as_tensor(b),
                    M=(lambda r: r / dt) if precond else krylov._identity,
                    rtol=1e-12, maxiter=200)
    ref = jkrylov.cg(lambda x: Aj @ x, jnp.asarray(b),
                     M=(lambda r: r / dj) if precond else jkrylov._identity,
                     rtol=1e-12, maxiter=200)
    assert 0 < res.iters < 200 and abs(res.iters - int(ref.iters)) <= 1
    assert float(res.residual) <= 1e-12
    x = np.linalg.solve(A, b)
    assert np.linalg.norm(res.x.numpy() - x) <= 1e-10 * np.linalg.norm(x)
    assert np.linalg.norm(res.x.numpy() - np.asarray(ref.x)) <= (
        1e-10 * np.linalg.norm(x))
    zero = krylov.cg(lambda x: At @ x, torch.zeros(40, dtype=torch.float64))
    assert zero.iters == 0 and not zero.x.any()


@pytest.mark.parametrize("restart,precond", [(30, False), (30, True),
                                             (7, False)])
def test_gmres_matches_reference(restart, precond):
    """The cycle count (iterations in whole restarts), the early exit
    inside a cycle and the solution agree with the reference's GMRES."""
    A, b = _system(seed=9)
    d = np.diag(A).copy()
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    x0 = np.random.default_rng(10).standard_normal(len(b))
    res = krylov.gmres(lambda x: At @ x, torch.as_tensor(b),
                       x0=torch.as_tensor(x0),
                       M=(lambda r: r / dt) if precond else krylov._identity,
                       rtol=1e-12, maxiter=400, restart=restart)
    ref = jkrylov.gmres(lambda x: Aj @ x, jnp.asarray(b), x0=jnp.asarray(x0),
                        M=(lambda r: r / dj) if precond
                        else jkrylov._identity,
                        rtol=1e-12, maxiter=400, restart=restart)
    # whole cycles on both sides; one cycle apart at most (round-off at
    # a cycle's end)
    assert res.iters % restart == 0
    assert abs(res.iters - int(ref.iters)) <= restart
    assert float(res.residual) <= 1e-12 and res.residual.ndim == 0
    x = np.linalg.solve(A, b)
    assert np.linalg.norm(res.x.numpy() - x) <= 1e-10 * np.linalg.norm(x)
    assert np.linalg.norm(res.x.numpy() - np.asarray(ref.x)) <= (
        1e-10 * np.linalg.norm(x))


def test_gmres_zero_rhs_f32_and_iteration_cap():
    b = torch.zeros(6, dtype=torch.float64)
    res = krylov.gmres(lambda x: 2.0 * x, b)
    assert res.iters == 0 and not res.x.any()
    A, bb = _system(seed=11)
    A32 = torch.as_tensor(A, dtype=torch.float32)
    res = krylov.gmres(lambda x: A32 @ x,
                       torch.as_tensor(bb, dtype=torch.float32), rtol=1e-5,
                       maxiter=200, restart=20)
    assert res.x.dtype == torch.float32 and float(res.residual) <= 1e-5
    # maxiter caps the cycles: one cycle of 5 cannot reach 1e-12 here
    A64 = torch.as_tensor(A)
    res = krylov.gmres(lambda x: A64 @ x, torch.as_tensor(bb), rtol=1e-12,
                       maxiter=5, restart=5)
    assert res.iters == 5 and float(res.residual) > 1e-12
