"""The port's PIHNA transient step against rdcfes_tpu: 3 mixed-precision
steps on box_tet_mesh(4,4,4) at rtol 3e-11 agree within 1e-10 relative
per step (the bar of tests/test_fastpath.py:102-142: identical math,
solver-tolerance differences only), each residual within rtol.  The
reference runs its CPU path (fast_gather off, XLA f64) and solves each
step with one f64 BiCGStab at rtol 1e-12: the answer the mixed-precision
refinement has to reach, from a program with 3 traced matvecs where the
reference's own mixed solve has 11 (its compile is what this file's
fixture costs).  The port runs the plain versions of its kernels."""

import numpy as np
import pytest
import torch

from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.models.pihna import pihna_blocks as jax_pihna_blocks
from rdcfes_tpu.models.pihna import pihna_physics
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

from rdcfes_tpu_torch.mesh import box_hex_mesh, box_tet_mesh
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.systems.solid import SolidSystem
from rdcfes_tpu_torch.utils.convert import mesh_from_arrays, state_from_numpy
from rdcfes_tpu_torch.utils.device import cuda_device

from tests.torch_helpers import quick_compile

RTOL = 3e-11
REF_RTOL = 1e-12  # the reference's f64 solve
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    """The reference's jit compiles, which dominate this file's time,
    without XLA's expensive passes (tests/torch_helpers.quick_compile)."""
    with quick_compile():
        yield


def _case():
    mesh = box_tet_mesh(4, 4, 4)
    Kk = 2.39e5
    p = default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk,
             necrosis_v=300.0 / Kk, produce_c=-2.5, switch_c2h=1.0,
             switch_h2c=1.82, switch_h2n=0.5, diffuse_v=0.5,
             produce_v=10.0, secrete_a_c=2.77e-13, secrete_a_h=5.22e-10,
             decay_a=5678.4)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(0)
    u0 = np.zeros((mesh.n_nodes, 5))
    r2 = ((mesh.coords - 0.5) ** 2).sum(axis=1)
    u0[:, 1] = 2000 * np.exp(-r2 / 0.1)
    u0[:, 2] = 500 * np.exp(-r2 / 0.1)
    u0[:, 3] = 7200 * (1 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    return mesh, p, u0


@pytest.fixture(scope="module")
def reference():
    """rdcfes_tpu's 3 steps (state dicts as NumPy), computed once."""
    mesh, p, u0 = _case()
    jm = jax_box_tet_mesh(4, 4, 4)
    sys_ = JaxSystem(jm, 5, pihna_physics, physics_blocks=jax_pihna_blocks,
                     precision="f64", fast_gather="off", rtol=REF_RTOL)
    st = sys_.initial_state(u0)
    states = []
    for _ in range(STEPS):
        st, _, res = sys_.step(st, params=p)
        assert float(res) <= REF_RTOL
        states.append(sys_.gather_state(st))
    return mesh, p, u0, states


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_run_steps_matches_reference_per_step(reference):
    mesh, p, u0, states = reference
    s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=RTOL,
                           precision="mixed", device="cpu")
    st = s.initial_state(u0)
    for ref in states:
        st, its, ress = s.run_steps(st, 1, params=p)
        got = s.gather_state(st)
        assert its.shape == (1,) and int(its[0]) > 0
        assert float(ress[0]) <= RTOL
        for key in ("u", "u_old", "u_older", "u_raw"):
            assert _rel(got[key], ref[key]) < 1e-10, key
        assert (got["u"] >= 0).all()


def test_run_steps_three_at_once_matches_reference(reference):
    mesh, p, u0, states = reference
    s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=RTOL,
                           precision="mixed", device="cpu")
    st, its, ress = s.run_steps(s.initial_state(u0), STEPS, params=p)
    assert its.shape == (STEPS,) and ress.shape == (STEPS,)
    assert float(ress.max()) <= RTOL
    assert _rel(st["u"].numpy(), states[-1]["u"]) < 1e-10


def test_step_continues_from_reference_state(reference):
    """The reference's gathered state after step 1, moved across with
    state_from_numpy, steps to the reference's step-2 state."""
    mesh, p, _, states = reference
    s = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=RTOL,
                           precision="mixed", device="cpu")
    st, _, res = s.step(state_from_numpy(states[0], s.device), params=p)
    assert float(res) <= RTOL
    assert _rel(st["u"].numpy(), states[1]["u"]) < 1e-10


def test_precond_refresh_step_and_run_steps_agree():
    """step()'s cached block-Jacobi inverse and run_steps' i % k refresh
    rebuild it on the same steps, so both give the same trajectory."""
    mesh, p, u0 = _case()
    a = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=RTOL,
                           precision="mixed", precond_refresh=2,
                           device="cpu")
    st = a.initial_state(u0)
    its = []
    for _ in range(STEPS):
        st, it, _ = a.step(st, params=p)
        its.append(it)
    b = TransientRDCSystem(mesh, 5, pihna_blocks, rtol=RTOL,
                           precision="mixed", precond_refresh=2,
                           device="cpu")
    sb, its_b, _ = b.run_steps(b.initial_state(u0), STEPS, params=p)
    assert its == its_b.tolist()
    assert torch.equal(st["u"], sb["u"])


def test_constraints_hold_in_a_step():
    """constraints= (rows [h, a, b]) is honoured: the step's state keeps
    u_h = (u_a + u_b) / 2 (tests/test_torch_amr.py holds the constrained
    step to the reference's)."""
    mesh, p, u0 = _case()
    s = TransientRDCSystem(mesh, 5, pihna_blocks, device="cpu",
                           constraints=np.array([[0, 1, 2]]))
    st, _, res = s.step(s.initial_state(u0), params=p)
    assert float(res) <= s.rtol
    u = st["u"]
    assert torch.equal(u[0], 0.5 * (u[1] + u[2]))


def test_unported_paths_raise():
    mesh, p, u0 = _case()
    # HEX8 runs the generic path, TRI3 the affine one; a system needs a
    # block form or a dense one
    hexm = jax_box_hex_mesh(1, 1, 1)
    TransientRDCSystem(mesh_from_arrays(hexm.coords, hexm.connectivity,
                                        "HEX8"), 5, pihna_blocks,
                       device="cpu")
    tri3 = mesh_from_arrays(np.eye(3), np.arange(3)[None], "TRI3")
    assert TransientRDCSystem(tri3, 5, pihna_blocks,
                              device="cpu").blocks[0].affine
    with pytest.raises(ValueError, match="physics"):
        TransientRDCSystem(tri3, 5, None, device="cpu")
    for kw in ({"precision": "f16"}, {"method": "cg"}):
        with pytest.raises(ValueError):
            TransientRDCSystem(mesh, 5, pihna_blocks, device="cpu", **kw)
    # a moving mesh constructs, and its step needs the current coords
    moving = TransientRDCSystem(mesh, 5, pihna_blocks, device="cpu",
                                moving_mesh=True)
    for step in (lambda st: moving.step(st, params=p),
                 lambda st: moving.run_steps(st, 1, params=p)):
        with pytest.raises(ValueError, match="coords"):
            step(moving.initial_state(u0))
    # a fixed mesh ignores coords, as the reference does
    s = TransientRDCSystem(mesh, 5, pihna_blocks, precision="mixed",
                           device="cpu")
    st = s.initial_state(u0)
    moved, _, _ = s.run_steps(st, 1, params=p, coords=mesh.coords + 1.0)
    fixed, _, _ = s.run_steps(st, 1, params=p)
    assert torch.equal(moved["u"], fixed["u"])
    with pytest.raises(ValueError):
        s.step(st, params={"dt": np.float32(0.1)})


def test_cuda_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        assert cuda_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            cuda_device()


def test_entry_points_default_to_the_card():
    """Built without a device, TransientRDCSystem and SolidSystem go to
    the CUDA card; on a machine without one they raise rather than run on
    the CPU."""
    mesh, _, _ = _case()
    hexm = box_hex_mesh(1, 1, 1)
    build = (lambda: TransientRDCSystem(mesh, 5, pihna_blocks),
             lambda: SolidSystem(hexm, {0: {}}, {0: (0.0, 0.0, 0.0)}))
    for make in build:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
