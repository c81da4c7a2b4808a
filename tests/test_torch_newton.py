"""One solid load step through the port's NewtonSolver and SolidSystem
against rdcfes_tpu on box_hex_mesh(3,3,3), loaded at pseudo-time 0.5:

* exact-f64 options (f64 tangent, f64 Krylov, Newton tolerances 1e-10):
  the positions agree within 1e-10 of the displacement scale (solver
  tolerance only: the same math in another summation order);
* the solid bench's options (f32 tangent, modified Newton, mixed-precision
  Krylov, rel. residual and step 1e-6): both converge in the same number
  of Newton iterations and drift apart by at most 1e-5 of the
  displacement scale (the bar of tests/test_solid.py's f32+reuse case);
* the f64 tangent under modified Newton and under "mixed" Krylov, and
  the unported options, which raise naming their ROADMAP item."""

import numpy as np
import pytest
import torch

from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.solvers.newton import NewtonOptions as JaxOptions
from rdcfes_tpu.systems.solid import SolidSystem as JaxSolid

from rdcfes_tpu_torch.fem import kernels
from rdcfes_tpu_torch.mesh import box_hex_mesh
from rdcfes_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver
from rdcfes_tpu_torch.systems.solid import SolidSystem

PT = 0.5
KW = dict(materials={0: {"young": 1.0e3, "poisson": 0.3}},
          bcs={0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)},
          penalty=1.0e6)
EXACT = dict(max_nonlinear_iterations=20, relative_residual_tolerance=1e-10,
             relative_step_tolerance=1e-10, absolute_residual_tolerance=1e-10,
             linear_precision="f64")
BENCH = dict(max_nonlinear_iterations=20, relative_residual_tolerance=1e-6,
             relative_step_tolerance=1e-6, reuse_tangent=True,
             linear_precision="mixed")
CASES = {"exact": (EXACT, "f64"), "bench": (BENCH, "f32")}


def _port(opts, tp, ops=kernels.KERNEL_OPS):
    s = SolidSystem(box_hex_mesh(3, 3, 3), newton=NewtonOptions(**opts),
                    tangent_precision=tp, device="cpu", ops=ops, **KW)
    return s, s.run_solver(s.initial_positions(), PT)


@pytest.fixture(scope="module")
def reference():
    """rdcfes_tpu's load steps, (x (N, 3), iters, converged, |R|/|R0|)."""
    m = jax_box_hex_mesh(3, 3, 3)
    out = {}
    for name, (opts, tp) in CASES.items():
        s = JaxSolid(m, newton=JaxOptions(**opts), tangent_precision=tp,
                     **KW)
        r = s.run_solver(s.initial_positions(), PT)
        out[name] = (np.asarray(r.x), int(r.iters), bool(r.converged),
                     float(r.residual_norm) / float(r.initial_residual_norm))
    out["X0"] = m.coords
    return out


def _drift(x, ref, X0):
    return float(np.abs(x - ref).max() / np.abs(ref - X0).max())


def test_exact_f64_load_step_matches_reference(reference):
    xr, itr, conv, _ = reference["exact"]
    s, r = _port(*CASES["exact"])
    assert conv and r.converged
    assert r.residual_norm <= 1e-10 * r.initial_residual_norm + 1e-10
    assert r.linear_iters > 0
    assert _drift(r.x.numpy(), xr, reference["X0"]) < 1e-10
    # the top face moves down by ~ pseudo-time * 0.05 (penalty-approximate)
    u = s.displacement(r.x).numpy()
    top = s.mesh.coords[:, 2] > 1.0 - 1e-9
    np.testing.assert_allclose(u[top, 2], -0.05 * PT * 1.000001, rtol=2e-3)


def test_bench_options_load_step_matches_reference(reference):
    xr, itr, conv, ratio = reference["bench"]
    _, r = _port(*CASES["bench"])
    assert conv and r.converged and ratio <= 1e-6
    assert r.iters == itr
    assert r.residual_norm / r.initial_residual_norm <= 1e-6
    assert _drift(r.x.numpy(), xr, reference["X0"]) < 1e-5


def test_kernel_ops_and_plain_ops_agree_on_cpu():
    """On CPU tensors every wrapper takes its plain version: the two ops
    tables give the same load step bit for bit, and launch nothing."""
    kernels.reset_launch_counts()
    _, a = _port(*CASES["bench"])
    _, b = _port(*CASES["bench"], ops=kernels.PLAIN_OPS)
    assert torch.equal(a.x, b.x) and a.linear_iters == b.linear_iters
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("extra", [
    {"reuse_tangent": True}, {"linear_precision": "mixed"}])
def test_f64_tangent_variants_converge_to_exact(reference, extra):
    """Modified Newton and mixed-precision Krylov on the f64 tangent land
    on the exact-f64 equilibrium within the solver tolerances."""
    xr = reference["exact"][0]
    _, r = _port({**EXACT, **extra}, "f64")
    assert r.converged
    assert _drift(r.x.numpy(), xr, reference["X0"]) < 1e-6


def test_unported_newton_options_raise():
    s = SolidSystem(box_hex_mesh(1, 1, 1), device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NewtonSolver(s.sp, NewtonOptions(linear_method="gmres"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NewtonSolver(s.sp, NewtonOptions(), constraints=np.array([[0, 1, 2]]))
    with pytest.raises(ValueError):
        NewtonSolver(s.sp, NewtonOptions(linear_precision="f16"))
