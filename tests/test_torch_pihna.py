"""rdcfes_tpu_torch PIHNA physics against rdcfes_tpu: the same u_qp and
grad_qp (NumPy, seeded) give the same coefficient blocks within 1e-13
relative (largest entry of each block), and the same blocks are
structurally absent (the Python float 0.0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.models import pihna as jpihna

from rdcfes_tpu_torch.models import pihna
from rdcfes_tpu_torch.utils import scalars

from tests.torch_helpers import quick_compile

TOL = 1e-13
KK = 2.39e5


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    """The reference's jit compiles, which dominate this file's time,
    without XLA's expensive passes (tests/torch_helpers.quick_compile)."""
    with quick_compile():
        yield


def _deck(taxis: bool):
    p = pihna.default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=KK,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500.0 / KK, necrosis_h=200.0 / KK,
             necrosis_v=300.0 / KK, produce_c=-2.5, switch_c2h=1.0,
             switch_h2c=1.82, switch_h2n=0.5, diffuse_v=0.5, produce_v=10.0,
             secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, decay_a=5678.4)
    if taxis:  # every D (taxis) block live, diffusion of c and h on
        p.update(diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0, taxis_h=4e-5,
                 taxis_v=1e-4, uptake_a_v=1e-3)
    return {k: float(v) for k, v in p.items()}


def _inputs(seed=3, Q=5, E=400):
    """Quadrature values spanning every clamp branch: Te across (0, 1) and
    beyond, Ve in and out of (0, 1), c/h/v around the gating threshold."""
    rng = np.random.default_rng(seed)
    u = np.empty((5, Q, E))
    u[0] = rng.uniform(0, 5e4, (Q, E))
    u[1] = rng.uniform(0, 2e5, (Q, E)) * (rng.random((Q, E)) > 0.1)
    u[2] = rng.uniform(0, 4e4, (Q, E)) * (rng.random((Q, E)) > 0.1)
    u[3] = rng.uniform(0, 8e3, (Q, E)) * (rng.random((Q, E)) > 0.1)
    u[4] = rng.uniform(0, 3e-8, (Q, E))
    u[1:4, :, :7] = 0.0                       # c + h + v == 0
    u[1, :, 7:9] = 1.0                         # exactly at Lambda_k
    g = rng.standard_normal((5, 3, E)) * 50.0  # affine: one gradient
    grad = np.broadcast_to(g[:, None], (5, Q, 3, E)).copy()
    return u, grad


def _check_blocks(tb, jb):
    n_live = 0
    for name in ("A", "B", "C", "D", "E"):
        tl, jl = getattr(tb, name), getattr(jb, name)
        if name in ("A", "B"):
            tl, jl = [tl], [jl]
        for trow, jrow in zip(tl, jl):
            for t, j in zip(trow, jrow):
                if isinstance(j, float):
                    assert isinstance(t, float) and t == j == 0.0, name
                    continue
                n_live += 1
                j = np.asarray(j)
                t = t.numpy()
                assert t.shape == j.shape and t.dtype == j.dtype, name
                scale = np.abs(j).max()
                err = np.abs(t - j).max()
                assert err <= TOL * max(scale, 1e-300), (name, err, scale)
    return n_live


@pytest.mark.parametrize("taxis", [False, True])
def test_pihna_blocks_match(taxis):
    p = _deck(taxis)
    u, grad = _inputs()
    jb = jpihna.pihna_blocks(jnp.asarray(u), jnp.asarray(grad), {}, p)
    tb = pihna.pihna_blocks(torch.as_tensor(u), torch.as_tensor(grad), {}, p)
    n_live = _check_blocks(tb, jb)
    if taxis:
        assert all(not isinstance(tb.D[v][w], float)
                   for v in (1, 2, 3) for w in range(4))
    else:  # the bench deck: taxis off, only diffuse_v
        assert [not isinstance(tb.D[v][w], float) for v in range(5)
                for w in range(5)].count(True) == 4
        assert n_live == 5 + 1 + 20 + 4 + 1


@pytest.mark.parametrize("ek", [3.0, 2.5, 1.0])
def test_crowding_factor_and_vascular_fraction_match(ek):
    Te = np.concatenate([np.linspace(-0.5, 1.5, 41), [0.0, 1.0]])
    t, dt = pihna.crowding_factor(torch.as_tensor(Te), KK, ek)
    jt, jdt = jpihna.crowding_factor(jnp.asarray(Te), KK, ek)
    assert np.allclose(t.numpy(), np.asarray(jt), rtol=TOL, atol=0)
    assert np.allclose(dt.numpy(), np.asarray(jdt), rtol=TOL, atol=0)
    c = np.array([0.0, 1.0, 2.0, 0.0, 5.0])
    h = np.array([0.0, 3.0, 0.0, 0.0, 1.0])
    v = np.array([0.0, 1.0, 2.0, 4.0, -9.0])
    for x, y in zip(pihna.vascular_fraction(*map(torch.as_tensor, (c, h, v))),
                    jpihna.vascular_fraction(*map(jnp.asarray, (c, h, v)))):
        assert np.array_equal(x.numpy(), np.asarray(y))


def test_default_params_and_vars():
    assert pihna.default_params() == jpihna.default_params()
    assert pihna.PIHNA_VARS == jpihna.PIHNA_VARS


def test_scalars():
    x = torch.tensor([-2.0, 0.5, 3.0], dtype=torch.float64)
    for n in range(2, 10):
        f = getattr(scalars, f"pow{n}")
        assert torch.allclose(f(x), x ** n, rtol=1e-15, atol=0)
    assert scalars.apply_bounds(0.0, x, 1.0).tolist() == [0.0, 0.5, 1.0]
    assert scalars.apply_lbound(0.0, x).tolist() == [0.0, 0.5, 3.0]
    assert scalars.apply_ubound(x, 1.0).tolist() == [-2.0, 0.5, 1.0]
    assert scalars.sign(x, tol=1.0).tolist() == [-1, 0, 1]
