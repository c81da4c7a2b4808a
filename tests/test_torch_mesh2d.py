"""2D meshes (TRI3 and QUAD4 volume elements, EDGE2 boundary sides) in
rdcfes_tpu_torch, held to rdcfes_tpu on the same seeded NumPy inputs (the
port's counterpart of tests/test_mesh2d.py).

Tolerances: element tables, meshes, Gmsh text, VTU and CSV bytes equal;
geometry and boundary-edge geometry within 1e-13 of the largest value
(the same unrolled sums, f64 reassociation only); the logistic ODE
recurrence at test_mesh2d.py's 1e-9; one PIHNA step on the qp path
(PLAIN_OPS, f64, rtol 1e-14) within 1e-10 relative L2 of the reference's
eager `assemble` solved directly (the Krylov tolerance times the
system's conditioning, far inside 1e-10).
"""

import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import elements as jel
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.fem.amr import kelly_error_indicator as jax_kelly
from rdcfes_tpu.io import csv_metrics as jcsv
from rdcfes_tpu.io import exodus as jexodus
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import box_quad_mesh as jax_box_quad_mesh
from rdcfes_tpu.mesh import box_tri_mesh as jax_box_tri_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.models import pihna as jpihna
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

from rdcfes_tpu_torch.fem import elements, geometry
from rdcfes_tpu_torch.fem.amr import kelly_error_indicator
from rdcfes_tpu_torch.fem.kernels import PLAIN_OPS
from rdcfes_tpu_torch.fem.weakform import WeakForm
from rdcfes_tpu_torch.io import csv_metrics, exodus, vtu
from rdcfes_tpu_torch.mesh import box_quad_mesh, box_tri_mesh, gmsh
from rdcfes_tpu_torch.models.pihna import pihna_blocks
from rdcfes_tpu_torch.native import read_gmsh_native
from rdcfes_tpu_torch.systems import TransientRDCSystem
from tests.torch_helpers import (quick_compile, reference_assembled_step,
                                 rel_l2)

TOL = 1e-13


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """The reference's eager calls compile each primitive they meet; at
    these sizes that compile is their whole cost, so skip XLA's
    optimisation passes (tests/torch_helpers.quick_compile)."""
    with quick_compile():
        yield
MESHES = {"TRI3": (jax_box_tri_mesh, box_tri_mesh),
          "QUAD4": (jax_box_quad_mesh, box_quad_mesh)}
BOUNDS = ((0.0, 2.0), (0.0, 1.5))
ARRAYS = ("coords", "connectivity", "subdomain_id", "boundary_faces",
          "boundary_elem", "boundary_side", "boundary_id")


def rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _same_mesh(a, b) -> bool:
    return a.elem_type == b.elem_type and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in ARRAYS)


def _jittered(m, seed=0):
    x = m.coords.copy()
    x[:, :2] += 0.03 * np.random.default_rng(seed).standard_normal(
        (m.n_nodes, 2))
    return x


@pytest.mark.parametrize("elem_type", ["TRI3", "QUAD4", "EDGE2"])
def test_tables_equal(elem_type):
    for a, b in zip(elements.quadrature(elem_type) + elements.tabulate(
            elem_type), jel.quadrature(elem_type) + jel.tabulate(elem_type)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("elem_type", list(MESHES))
def test_meshes_equal(elem_type):
    jfn, fn = MESHES[elem_type]
    jm, m = jfn(4, 3, bounds=BOUNDS), fn(4, 3, bounds=BOUNDS)
    assert m.dim == 2 and _same_mesh(m, jm)
    assert np.array_equal(m.element_volumes(), jm.element_volumes())
    assert set(np.unique(m.boundary_id)) == {1, 2, 3, 4}


@pytest.mark.parametrize("elem_type", list(MESHES))
def test_geometry_matches(elem_type):
    m = MESHES[elem_type][1](3, 2, bounds=BOUNDS)
    x = _jittered(m)
    ref = jgeo.geometry_factors(jnp.asarray(x), jnp.asarray(m.connectivity),
                                elem_type)
    out = geometry.geometry_factors(torch.as_tensor(x),
                                    torch.as_tensor(m.connectivity),
                                    elem_type)
    assert np.array_equal(out[0], ref[0])
    assert rel(out[1], ref[1]) < TOL and rel(out[2], ref[2]) < TOL
    assert not out[2][:, :, 2].any()  # in-plane gradients, zero z
    faces = (jgeo.face_geometry_factors(jnp.asarray(x),
                                        jnp.asarray(m.boundary_faces),
                                        "EDGE2"),
             geometry.face_geometry_factors(torch.as_tensor(x),
                                            torch.as_tensor(
                                                m.boundary_faces), "EDGE2"))
    for r, o in zip(*faces):
        assert rel(o, r) < TOL


@pytest.mark.parametrize("elem_type", list(MESHES))
def test_gmsh_vtu_and_csv_match(elem_type, tmp_path):
    """The Gmsh text, both parsers' arrays, the VTU bytes and the PIHNA CSV
    row equal the reference's; ExodusII raises where the reference's
    does."""
    jm = MESHES[elem_type][0](3, 2)
    jm.boundary_id[:] = np.arange(len(jm.boundary_id)) % 5
    text = jgmsh.dumps(jm)
    path = str(tmp_path / "m.msh")
    with open(path, "w") as f:
        f.write(text)
    for read in (lambda: gmsh.read_numpy(io.StringIO(text)),
                 lambda: read_gmsh_native(path), lambda: gmsh.read(path)):
        m = read()
        assert _same_mesh(m, jgmsh.read(io.StringIO(text)))
        assert gmsh.dumps(m) == text
    rng = np.random.default_rng(3)
    u = rng.random((m.n_nodes, 5)) * np.array([1e3, 1e3, 1e3, 1e4, 1.0])
    fields = [("n", u[:, 0]), ("c", u[:, 1])]
    jvtu.write_vtu(str(tmp_path / "a.vtu"), jm, fields)
    vtu.write_vtu(str(tmp_path / "b.vtu"), m, fields)
    with open(tmp_path / "a.vtu") as a, open(tmp_path / "b.vtu") as b:
        assert a.read() == b.read()
    p = {**jpihna.default_params(), "range_active_tumor_min": 500.0,
         "range_active_tumor_max": 1e9, "range_necrotic_min": 100.0,
         "range_necrotic_max": 1e9, "range_vascularity_min": 7200.0,
         "range_vascularity_max": 1e9, "range_total_cell_min": 1e-6,
         "range_total_cell_max": 1e9}
    rows = [io.StringIO(), io.StringIO()]
    jcsv.pihna_row(rows[0], jm, u, 0.5, p)
    csv_metrics.pihna_row(rows[1], m, u, 0.5, p)
    assert rows[0].getvalue() == rows[1].getvalue()
    for write, mesh in ((jexodus.write_exodus, jm), (exodus.write_exodus, m)):
        with pytest.raises(KeyError, match=elem_type):
            write(str(tmp_path / "m.exo"), mesh)


@pytest.mark.parametrize("rows,match", [
    ("1\n1 9 2 1 1 1 2 3 4 5 6\n", "unsupported 2D volume element"),
    ("2\n1 2 2 1 1 1 2 6\n2 3 2 1 1 2 5 3 6\n", "mixed-type 2D meshes"),
])
def test_unsupported_2d_files_rejected(rows, match, tmp_path):
    """A TRI6-only and a mixed-type 2D file: the native parser refuses
    them and the NumPy parser raises the reference's ValueError."""
    text = ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n6\n1 0 0 0\n"
            "2 1 0 0\n3 0 1 0\n4 0.5 0 0\n5 0.5 0.5 0\n6 0 0.5 0\n"
            f"$EndNodes\n$Elements\n{rows}$EndElements\n")
    path = str(tmp_path / "bad.msh")
    with open(path, "w") as f:
        f.write(text)
    with pytest.raises(ValueError, match="code"):
        read_gmsh_native(path)
    for read in (jgmsh.read, gmsh.read):
        with pytest.raises(ValueError, match=match):
            read(path)


def test_kelly_2d_raises_as_reference():
    jm = jax_box_tri_mesh(3, 3)
    m = box_tri_mesh(3, 3)
    u = np.random.default_rng(0).random((m.n_nodes, 1))
    with pytest.raises(NotImplementedError) as ref:
        jax_kelly(jm, u, [0])
    with pytest.raises(NotImplementedError) as out:
        kelly_error_indicator(m, u, [0])
    assert str(out.value) == str(ref.value)


def logistic_rd_physics(D=0.1, rho=1.0):
    """tests/test_transient.py's logistic_rd_physics as a port WeakForm:
    u_t = div(D grad u) + rho u (1 - u), linearized CN."""

    def physics(u_qp, grad_qp, fields, params):
        dt2 = params["dt"] / 2.0
        u = u_qp[0]
        return WeakForm(A=(u + dt2 * rho * u * (1.0 - u))[None],
                        B=(-dt2 * D) * grad_qp[:1],
                        C=(1.0 - dt2 * rho * (1.0 - 2.0 * u))[None, None],
                        E=(dt2 * D) * torch.ones_like(u)[None, None])

    return physics


@pytest.mark.parametrize("elem_type", list(MESHES))
def test_logistic_uniform_matches_ode_2d(elem_type):
    """The dense path on a 2D mesh: a uniform state under Neumann
    boundaries stays uniform and follows the linearized-CN logistic
    recurrence (test_mesh2d.py's bars)."""
    m = MESHES[elem_type][1](3, 3)
    s = TransientRDCSystem(m, 1, physics=logistic_rd_physics(0.1, 2.0),
                           device="cpu", ops=PLAIN_OPS)
    dt, u_ref = 0.05, 0.1
    state = s.initial_state(np.full((m.n_nodes, 1), u_ref))
    for _ in range(8):
        state, _, res = s.step(state, params={"dt": dt})
        u_ref = (u_ref + 0.5 * dt * 2.0 * u_ref * (1 - u_ref)) / (
            1.0 - 0.5 * dt * 2.0 * (1 - 2 * u_ref))
        u = state["u"].numpy()
        assert np.ptp(u) < 1e-9
        np.testing.assert_allclose(u.mean(), u_ref, rtol=1e-9)


def test_diffusion_decays_2d():
    m = box_tri_mesh(6, 6)
    s = TransientRDCSystem(m, 1, physics=logistic_rd_physics(0.5, 0.0),
                           device="cpu", ops=PLAIN_OPS)
    u0 = 1.0 + np.cos(np.pi * m.coords[:, 0])
    state = s.initial_state(u0[:, None])
    for _ in range(5):
        state, _, _ = s.step(state, params={"dt": 0.02})
    u = state["u"].numpy()[:, 0]
    assert np.abs(u - 1.0).max() < 0.8 * np.abs(u0 - 1.0).max()
    assert u.min() > 0.0


def pihna_case(mesh, seed=0, live=True):
    """A PIHNA deck and a smooth seeded state on `mesh` (coordinates in
    [0, 1]^d): live, every operator on; else the bench deck's operators
    (diffuse_v alone of the transport terms)."""
    Kk = 2.39e5
    p = jpihna.default_params()
    p.update(dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
             cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
             necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk,
             necrosis_v=300.0 / Kk, produce_c=-2.5, switch_c2h=1.0,
             switch_h2c=1.82, switch_h2n=0.5, diffuse_v=0.5,
             produce_v=10.0, secrete_a_c=2.77e-13, secrete_a_h=5.22e-10,
             decay_a=5678.4)
    if live:
        p.update(diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0, taxis_h=4e-5,
                 taxis_v=1e-4, uptake_a_v=1e-3)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    r2 = ((mesh.coords - 0.5) ** 2).sum(axis=1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 2000 * np.exp(-r2 / 0.1)
    u0[:, 2] = 500 * np.exp(-r2 / 0.1)
    u0[:, 3] = 7200 * (1 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    return p, u0


@pytest.mark.parametrize("elem_type", list(MESHES))
def test_pihna_step_matches_reference_assembled(elem_type):
    """One PIHNA step on the qp path (TRI3 affine: K1-K3's plain
    versions; QUAD4 generic: K8's and K6's) against the reference's eager
    `assemble` and a direct solve, unclamped."""
    jfn, fn = MESHES[elem_type]
    jm, m = jfn(3, 3), fn(3, 3)
    p, u0 = pihna_case(m)
    jsys = JaxSystem(jm, 5, jpihna.pihna_physics, fast_gather="off")
    ref = reference_assembled_step(jsys, u0, {}, p)
    s = TransientRDCSystem(m, 5, pihna_blocks, rtol=1e-14, device="cpu",
                           ops=PLAIN_OPS)
    st, _, res = s.step(s.initial_state(u0), params=p)
    assert float(res) <= 1e-14
    assert rel_l2(st["u_raw"].numpy(), ref) < 1e-10


def pihna_cli_case(tmp_path, write_mesh):
    """make_pihna_case(n=2, n_steps=2) with its Gmsh file replaced by
    `write_mesh(path)`, pihna_case's state as the initial nodal field, HU
    = RT = 40, a VTU frame every step, the linear tolerance 1e-14 and a
    checkpoint after step 2.  Returns (case dir, the reference's read of
    the Gmsh file, u0)."""
    from rdcfes_tpu_torch import cases

    d = cases.make_pihna_case(str(tmp_path / "c"), n=2, n_steps=2)
    write_mesh(os.path.join(d, "Brain_Model.msh"))
    jm = jgmsh.read(os.path.join(d, "Brain_Model.msh"))
    _, u0 = pihna_case(jm)
    np.savetxt(os.path.join(d, "Brain_Model_Initial_Nodal_Field.dat"), u0)
    np.savetxt(os.path.join(d, "Brain_Model_Initial_Elemental_Field.dat"),
               np.full((jm.n_elems, 2), 40.0))
    deck = os.path.join(d, "input.dat")
    with open(deck) as f:
        text = f.read().replace("output_step = 10", "output_step = 1")
    with open(deck, "w") as f:
        f.write(text + "solver/linear/tolerance = 1e-14\n"
                "checkpoint/step = 2\n")
    return d, jm, u0


def pihna_cli_against_reference(d, jm, u0, tmp_path, monkeypatch,
                                assembled=True):
    """`cli.main -m pihna` in the case dir d, two steps, held to the
    reference on the deck's own inputs: frame 0 byte-equal to the
    reference's writer on u0; the checkpointed state equal (within 1e-12)
    to the port's TransientRDCSystem (PLAIN_OPS) stepped twice from u0
    with the deck's params; with `assembled`, the driver's second step
    (its unclamped u_raw from its first step's state) within 1e-10
    relative L2 of the reference's eager `assemble` solved directly; the
    CSV's last row and the last frame byte-equal to the reference's
    writers on the checkpointed state."""
    from rdcfes_tpu_torch import cli
    from rdcfes_tpu_torch.drivers import pihna as dpihna
    from rdcfes_tpu_torch.io.getpot import Deck

    monkeypatch.chdir(d)
    assert cli.main(["-m", "pihna"], device="cpu") == 0
    out = os.path.join(d, "PIHNA_simulation")
    frames = sorted(n for n in os.listdir(out) if n.endswith(".vtu"))
    assert len(frames) == 3
    hu = jvtu.elemental_to_nodal(jm, np.full(jm.n_elems, 40.0))

    def same_frame(u, name):
        ref = str(tmp_path / "ref.vtu")
        fields = [(nm, u[:, i]) for i, nm in enumerate(jpihna.PIHNA_VARS)]
        jvtu.write_vtu(ref, jm, fields + [("HU", hu), ("RT", hu)])
        with open(ref) as a, open(os.path.join(out, name)) as b:
            return a.read() == b.read()

    assert same_frame(u0, frames[0])
    deck = Deck(os.path.join(d, "input.dat"))
    p = dpihna.load_params(deck)
    ck = np.load(os.path.join(out, "checkpoint.npz"))
    s = TransientRDCSystem(gmsh.read(os.path.join(d, "Brain_Model.msh")),
                           5, pihna_blocks, rtol=1e-14, device="cpu",
                           ops=PLAIN_OPS)
    st = s.initial_state(u0)
    for _ in range(2):
        st, _, res = s.step(st, params=p)
        assert float(res) <= 1e-14
    for k in ("u", "u_old", "u_raw"):
        u = st[k].numpy()
        assert np.abs(ck[k] - u).max() <= 1e-12 * np.abs(u).max(), k
    if assembled:
        jsys = JaxSystem(jm, 5, jpihna.pihna_physics, fast_gather="off")
        ref = reference_assembled_step(jsys, ck["u_old"], {}, p)
        assert rel_l2(ck["u_raw"], ref) < 1e-10
    u = ck["u"]
    assert np.isfinite(u).all() and (u >= 0).all()
    buf = io.StringIO()
    jcsv.pihna_row(buf, jm, u, 2 * p["dt"],
                   {**p, **dpihna.load_ranges(deck)})
    rows = open(os.path.join(out, "output.csv")).read().splitlines()
    assert rows[-1] == buf.getvalue().strip()
    assert same_frame(u, frames[-1])


@pytest.mark.parametrize("elem_type", list(MESHES))
def test_cli_runs_a_2d_case(elem_type, tmp_path, monkeypatch):
    """`cli.main -m pihna` on a TRI3 or QUAD4 Gmsh file (3 x 3 cells in
    the brain's bounds), held to the reference by
    pihna_cli_against_reference, the second step to its assembled solve."""
    m = MESHES[elem_type][1](3, 3, bounds=((0.0, 150.0), (0.0, 180.0)))
    d, jm, u0 = pihna_cli_case(tmp_path, lambda path: gmsh.write(m, path))
    pihna_cli_against_reference(d, jm, u0, tmp_path, monkeypatch)
