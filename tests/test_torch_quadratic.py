"""The quadratic types EDGE3, QUAD8, QUAD9, HEX20 and HEX27 in
rdcfes_tpu_torch, held to rdcfes_tpu on the same seeded NumPy inputs (the
port's counterpart of tests/test_quadratic_io.py).

Tolerances: element tables, meshes, Gmsh text and VTU bytes equal;
geometry and face geometry within 1e-13 of the largest value (the same
unrolled sums, f64 reassociation only); EDGE3 sides, which the
reference's face_geometry_factors does not take, against the exact
perimeter and outward normals at 1e-13; K8's plain version at HEX20 and
HEX27 within 1e-13 of the reference's interpolate_ue of the gathered
corners (the same sums over k in the same order, broadcast against term
by term); one PIHNA step on the qp path
(PLAIN_OPS, f64, rtol 1e-14) within 1e-10 relative L2 of the reference's
direct solution: on QUAD9 its eager `assemble`, on one HEX27 its eager
qp-path operator (tests/torch_helpers.reference_direct_step: the eager
assemble of a HEX27, 19,683 unrolled (i, j, q) terms, takes ~35 s).
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import elements as jel
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import Mesh as JaxMesh
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_quad_mesh as jax_box_quad_mesh
from rdcfes_tpu.mesh import core as jcore
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.models import pihna as jpihna
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

from rdcfes_tpu_torch.fem import elements, geometry, kernels
from rdcfes_tpu_torch.fem.kernels import PLAIN_OPS
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.mesh import core, gmsh
from rdcfes_tpu_torch.models.pihna import pihna_blocks
from rdcfes_tpu_torch.native import read_gmsh_native
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.utils.convert import mesh_from_reference
from tests.elevate import elevate_hex, elevate_quad
from tests.test_torch_mesh2d import (ARRAYS, pihna_case,
                                    pihna_cli_against_reference,
                                    pihna_cli_case, rel)
from tests.torch_helpers import (quick_compile, reference_assembled_step,
                                 reference_direct_step, rel_l2)

TOL = 1e-13


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """The reference's eager calls compile each primitive they meet; at
    these sizes that compile is their whole cost, so skip XLA's
    optimisation passes (tests/torch_helpers.quick_compile)."""
    with quick_compile():
        yield
QUADRATIC = ("QUAD8", "QUAD9", "HEX20", "HEX27")


def _ref_mesh(t, nx=2, jitter=0.0, seed=0):
    """A reference Mesh of type t: box_quad_mesh(nx, 2) or
    box_hex_mesh(nx, 1, 1) elevated, nodes jittered by `jitter`."""
    if t.startswith("QUAD"):
        b = jax_box_quad_mesh(nx, 2)
        x, conn = elevate_quad(b.coords, b.connectivity, t == "QUAD9")
    else:
        b = jax_box_hex_mesh(nx, 1, 1)
        x, conn = elevate_hex(b.coords, b.connectivity, t == "HEX27")
    rng = np.random.default_rng(seed)
    x = x.copy()
    d = 2 if t.startswith("QUAD") else 3
    x[:, :d] += jitter * rng.standard_normal((len(x), d))
    return JaxMesh(x, conn, t, None)


@pytest.mark.parametrize("t", QUADRATIC + ("EDGE3",))
def test_tables_equal(t):
    for a, b in zip(elements.quadrature(t) + elements.tabulate(t),
                    jel.quadrature(t) + jel.tabulate(t)):
        assert np.array_equal(a, b)
    if t != "EDGE3":
        assert core.ELEMENT_FACES[t] == jcore.ELEMENT_FACES[t]
        assert core.FACE_TYPE[t] == jcore.FACE_TYPE[t]
        assert core.NODES_PER_ELEM[t] == jcore.NODES_PER_ELEM[t]


@pytest.mark.parametrize("t", QUADRATIC)
def test_meshes_and_geometry_match(t):
    """Boundary extraction and volumes equal; geometry and the QUAD8 /
    QUAD9 faces of the hexes within 1e-13 (HEX20's volume geometry is
    held by tests/test_torch_fem.py and test_torch_solid.py)."""
    jm = _ref_mesh(t, jitter=0.03)
    m = core.Mesh(jm.coords, jm.connectivity, t)
    assert all(np.array_equal(getattr(m, f), getattr(jm, f))
               for f in ARRAYS)
    assert m.dim == jm.dim
    assert np.array_equal(m.element_volumes(), jm.element_volumes())
    x, conn = m.coords, m.connectivity
    if t != "HEX20":
        ref = jgeo.geometry_factors(jnp.asarray(x), jnp.asarray(conn), t)
        out = geometry.geometry_factors(torch.as_tensor(x),
                                        torch.as_tensor(conn), t)
        assert np.array_equal(out[0], ref[0])
        assert rel(out[1], ref[1]) < TOL and rel(out[2], ref[2]) < TOL
    if m.dim == 3:
        ft = core.FACE_TYPE[t]
        faces = (jgeo.face_geometry_factors(
            jnp.asarray(x), jnp.asarray(m.boundary_faces), ft),
            geometry.face_geometry_factors(
                torch.as_tensor(x), torch.as_tensor(m.boundary_faces), ft))
        for r, o in zip(*faces):
            assert rel(o, r) < TOL


@pytest.mark.parametrize("t", ("QUAD8", "QUAD9"))
def test_edge3_sides_outward(t):
    """EDGE3 sides of a quadratic quad mesh of the unit square: their
    lengths add up to the perimeter, and every normal points out."""
    m = mesh_from_reference(_ref_mesh(t))
    _, JxW, xyz, n = geometry.face_geometry_factors(
        torch.as_tensor(m.coords), torch.as_tensor(m.boundary_faces),
        "EDGE3")
    assert abs(float(JxW.sum()) - 4.0) < TOL * 4.0
    centre = torch.tensor([0.5, 0.5, 0.0], dtype=torch.float64)
    assert bool(((n * (xyz - centre)).sum(-1) > 0).all())
    assert not n[..., 2].any() and not xyz[..., 2].any()


@pytest.mark.parametrize("t", QUADRATIC)
def test_gmsh_and_vtu_match(t, tmp_path):
    """The Gmsh text, all three parsers' arrays and the VTU bytes equal
    the reference's; boundary ids survive the round trip."""
    jm = _ref_mesh(t, jitter=0.01)
    jm.boundary_id[:] = np.arange(len(jm.boundary_id)) + 1
    text = jgmsh.dumps(jm)
    path = str(tmp_path / "q.msh")
    with open(path, "w") as f:
        f.write(text)
    want = jgmsh.read(io.StringIO(text))
    for read in (lambda: gmsh.read_numpy(io.StringIO(text)),
                 lambda: read_gmsh_native(path), lambda: gmsh.read(path)):
        m = read()
        assert m.elem_type == t
        assert all(np.array_equal(getattr(m, f), getattr(want, f))
                   for f in ARRAYS)
        assert gmsh.dumps(m) == text
    fields = [("f", np.linspace(0.0, 1.0, m.n_nodes))]
    jvtu.write_vtu(str(tmp_path / "a.vtu"), jm, fields)
    vtu.write_vtu(str(tmp_path / "b.vtu"), m, fields)
    with open(tmp_path / "a.vtu") as a, open(tmp_path / "b.vtu") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("t", ("HEX20", "HEX27"))
def test_gather_interp_generic_plain_matches_reference(t):
    """K8's plain version (the corner gather through conn_T, then
    interpolate_ue) at HEX20 (20, 27) and HEX27 (27, 27), 5 species,
    within 1e-13 of the reference's interpolate_ue of the gathered
    corners, on box_hex_mesh(3, 1, 1) raised to t with jittered nodes (so
    dphi differs per q and element); on CPU tensors the wrapper is its
    plain version and launches nothing."""
    jm = _ref_mesh(t, nx=3, jitter=0.03, seed=18)
    x, conn = jm.coords, jm.connectivity
    phi, _, dphi = geometry.geometry_factors(torch.as_tensor(x),
                                             torch.as_tensor(conn), t)
    u = np.random.default_rng(18).standard_normal((5, len(x)))
    ref = jasm.interpolate_ue(jnp.asarray(u[:, conn.T]), phi,
                              jnp.asarray(dphi.numpy()))
    conn_T = torch.as_tensor(np.ascontiguousarray(conn.T))
    args = (torch.as_tensor(u), conn_T, phi, dphi)
    out = kernels.gather_interp_generic_plain(*args)
    Q, E = phi.shape[0], len(conn)
    assert out[0].shape == (5, Q, E) and out[1].shape == (5, Q, 3, E)
    for o, r in zip(out, ref):
        assert rel(o, r) < TOL
    before = kernels.launch_counts()
    for o, w in zip(out, kernels.gather_interp_generic(*args)):
        assert torch.equal(o, w)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("t", ("QUAD9", "HEX27"))
def test_pihna_step_matches_reference(t):
    """One PIHNA step on the qp path (K8's and K6's plain versions at
    QUAD9 (9, 9) and HEX27 (27, 27)) against the reference's direct
    solution, unclamped."""
    jm = (_ref_mesh("QUAD9", nx=2, jitter=0.02) if t == "QUAD9" else
          JaxMesh(*elevate_hex(jax_box_hex_mesh(1, 1, 1).coords,
                               jax_box_hex_mesh(1, 1, 1).connectivity, True),
                  "HEX27", None))
    m = mesh_from_reference(jm)
    # HEX27 on the bench deck's operators: each live block costs the
    # reference's eager qp path 729 (q, k) terms
    p, u0 = pihna_case(m, live=t == "QUAD9")
    jsys = JaxSystem(jm, 5, jpihna.pihna_physics,
                     physics_blocks=jpihna.pihna_blocks, fast_gather="off")
    ref = (reference_assembled_step(jsys, u0, {}, p) if t == "QUAD9" else
           reference_direct_step(jsys, jpihna.pihna_blocks, u0, {}, p))
    s = TransientRDCSystem(m, 5, pihna_blocks, rtol=1e-14, device="cpu",
                           ops=PLAIN_OPS)
    st, _, res = s.step(s.initial_state(u0), params=p)
    assert float(res) <= 1e-14
    assert rel_l2(st["u_raw"].numpy(), ref) < 1e-10


@pytest.mark.parametrize("t", QUADRATIC)
def test_cli_runs_quadratic_cases(t, tmp_path, monkeypatch):
    """`cli.main -m pihna` on a Gmsh file of each quadratic type, held to
    the reference by pihna_cli_against_reference: the two steps to the
    port's system on the deck's inputs, the artifacts to the reference's
    writers, and on QUAD8 and QUAD9 the second step to the reference's
    assembled solve (on HEX20 and HEX27 that eager `assemble` takes
    ~35 s; test_pihna_step_matches_reference holds HEX27's step)."""
    jm = _ref_mesh(t)
    jm.coords[:] *= np.array([75.0, 90.0, 75.0])  # into brain bounds

    def write(path):
        with open(path, "w") as f:
            f.write(jgmsh.dumps(jm))

    d, jm, u0 = pihna_cli_case(tmp_path, write)
    pihna_cli_against_reference(d, jm, u0, tmp_path, monkeypatch,
                                assembled=t.startswith("QUAD"))
