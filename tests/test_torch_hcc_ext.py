"""The port's coupled HCC on MIXED meshes and its remeshing, against
rdcfes_tpu.

* make_hcc_case(mixed=True)'s files byte-equal to the reference's (the
  Makefile launches rdcfes_tpu_torch.cli);
* the moving MixedTransientRDCSystem: 3 f64 steps on box_mixed_mesh(3, 2,
  2), each at another seeded smooth displacement, against the reference's
  `_step_moving_impl` from the same states (rtol 1e-14 in both): within
  1e-10 relative L2 per step;
* the HCC driver with remeshing on the mixed deck of
  tests/test_solid_constrained.py:168 and on make_hcc_case(n=3) (TET4,
  bisection), with tight solver tolerances: the refined mesh equals the
  reference's AMR (Kelly on the nodal pressure and the tumour c, the
  flags, MixedConstrained / bisection) applied to the port's fields at
  the remeshing step; the RDC state and the positions are the
  reference's P1 prolongation of the port's; the segment after
  remeshing equals both systems rebuilt on the reference's refined mesh
  (with its hanging nodes) and stepped from that prolongation, within
  1e-12; every hanging node of u and x on its masters' midpoint within
  1e-12; the last frame holds the refined mesh's cells.  A reference
  HCC driver run on the mixed deck takes 84 s here, so the driver is
  held to the reference's pieces;
* a run resumed from the checkpoint written after remeshing (the refined
  mesh beside it, the hanging nodes inside) ends where the uninterrupted
  run ends, within 1e-12.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu import cases as jcases
from rdcfes_tpu.fem import amr as jamr
from rdcfes_tpu.mesh import adapt as jadapt
from rdcfes_tpu.mesh import adapt_ext as jadapt_ext
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.models import hcc as jmodel
from rdcfes_tpu.systems import MixedTransientRDCSystem as JaxMixedSystem

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import common, coupled_hcc
from rdcfes_tpu_torch.drivers import solid as solid_driver
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.io.getpot import Deck
from rdcfes_tpu_torch.models import hcc
from rdcfes_tpu_torch.systems import (MixedTransientRDCSystem,
                                      TransientRDCSystem)
from rdcfes_tpu_torch.utils.convert import mesh_from_reference

from tests.test_torch_drivers import _run
from tests.test_torch_hcc import _moved, _params
from tests.torch_helpers import quick_compile, rel_l2


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def test_mixed_hcc_case_matches_reference(tmp_path):
    a, b = tmp_path / "port", tmp_path / "ref"
    cases.make_hcc_case(str(a), n=3, n_steps=6, n_loading=3, mixed=True)
    jcases.make_hcc_case(str(b), n=3, n_steps=6, n_loading=3, mixed=True)
    names = sorted(p.name for p in b.iterdir())
    assert sorted(p.name for p in a.iterdir()) == names
    for n in names:
        x, y = (a / n).read_bytes(), (b / n).read_bytes()
        if n == "Makefile":
            x = x.replace(b"rdcfes_tpu_torch.cli", b"rdcfes_tpu.cli")
        assert x == y, n


def test_moving_mixed_steps_match_reference():
    """Each block's geometry rebuilt from the coords of every step, the
    kernels' plain versions on it, against the reference's per-block
    element matrices on the same geometry."""
    jm = jax_box_mixed_mesh(3, 2, 2)
    p = _params()
    r2 = ((jm.coords - 0.5) ** 2).sum(axis=1)
    u0 = np.stack([0.6 - 0.4 * np.exp(-r2 / 0.1),
                   0.4 * np.exp(-r2 / 0.1), 0.05 * np.exp(-r2 / 0.05)], 1)
    ref = JaxMixedSystem(jm, 3, jmodel.hcc_physics, moving_mesh=True,
                         rtol=1e-14)
    port = MixedTransientRDCSystem(mesh_from_reference(jm), 3,
                                   hcc.hcc_blocks, moving_mesh=True,
                                   rtol=1e-14, device="cpu")
    st = ref.initial_state(u0)
    for seed in (1, 2, 3):
        x = _moved(jm.coords, seed, amp=0.03)
        want, _, rres = ref._step_moving_impl(st, {}, p, jnp.asarray(x))
        got, _, res = port.step(port.scatter_state(ref.gather_state(st)),
                                params=p, coords=torch.as_tensor(x))
        assert float(res) <= 1e-13 and float(rres) <= 1e-13
        assert rel_l2(got["u"], want["u"]) <= 1e-10
        st = want


# ----------------------------------------------------------------------
# the driver
# ----------------------------------------------------------------------
TIGHT = """solver/linear/tolerance = 1e-14
solver/nonlinear/relative_step_tolerance = 1.e-13
solver/nonlinear/relative_residual_tolerance = 1.e-12
solver/nonlinear/absolute_residual_tolerance = 1.e-9
"""
MIXED_DECK = """
directory = simulation
input_GMSH = input.msh
input_nodal = input.nodal
output_PARAVIEW = out
time_step = 0.01
number_of_time_steps = 4
number_of_loading_steps = 2
output_step = 4
remeshing_step = 2
mesh/AMR/max_steps = 1
cells/min_capacity = 0.0
cells/max_capacity = 1.0
cells/max_capacity/exponent = 3
produce/c = 0.5
diffuse/c = 0.05
necrosis/l = 0.1
necrosis/c = 0.1
BCs = ' 0 '
BC/0/displacement/0 = +0.000
BC/0/displacement/1 = +0.000
BC/0/displacement/2 = +0.000
BCs/displacement_penalty = 1.e+6
materials = ' 0 '
material/0/Hyperelastic/Young = 2.0e+3
material/0/Hyperelastic/Poisson = 0.4
material/0/Hyperelastic/VolumetricStretchRatio/rate_0 = 3.0e-1
material/0/Hyperelastic/VolumetricStretchRatio/rate_1 = 3.0e-1
material/0/Hyperelastic/VolumetricStretchRatio/rate_2 = 3.0e-1
""" + TIGHT


def _mixed_case(d, extra=""):
    jm = jax_box_mixed_mesh(4, 2, 2, bounds=((0, 1.0),) * 3)
    jgmsh.write(jm, os.path.join(d, "input.msh"))
    np.savetxt(os.path.join(d, "input.nodal"), np.stack([
        np.full(jm.n_nodes, 0.4),
        0.2 * np.exp(-10 * ((jm.coords - 0.5) ** 2).sum(axis=1)),
        np.full(jm.n_nodes, 0.01)], axis=1))
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(MIXED_DECK + extra)
    return jm


def _tet4_case(d, extra=""):
    cases.make_hcc_case(d, n=3, n_steps=4, n_loading=2)
    with open(os.path.join(d, "input.dat"), "a") as f:
        f.write("remeshing_step = 2\n" + TIGHT + extra)
    return jgmsh.read(os.path.join(d, "HCC_Model.msh"))


@pytest.fixture
def recorded(monkeypatch):
    """Every remeshing pass (mesh, indicators, result) and every RDC
    segment (system, state in, steps, coords, state out)."""
    rec = {"adapt": [], "rds": []}
    adapt, run_steps = common.Remesher.adapt, TransientRDCSystem.run_steps

    def adapt_(self, mesh, ind):
        rec["adapt"].append((mesh, ind, adapt(self, mesh, ind)))
        return rec["adapt"][-1][2]

    def run_steps_(self, state, n, *a, **kw):
        out = run_steps(self, state, n, *a, **kw)
        rec["rds"].append((self, state, n, kw.get("coords"), out[0]))
        return out

    monkeypatch.setattr(common.Remesher, "adapt", adapt_)
    monkeypatch.setattr(TransientRDCSystem, "run_steps", run_steps_)
    return rec


def _reference_remesh(jm, ind, refine, coarsen, max_level):
    """The reference HCC driver's remeshing pass on jm with nodal
    indicators ind (N, 2): (mesh, prolong, constraints)."""
    if jm.elem_type == "MIXED":
        eta = jadapt_ext.kelly_mixed(jm, jnp.asarray(ind), [0, 1])
    else:
        eta = jamr.kelly_error_indicator(jm, jnp.asarray(ind), [0, 1])
    flags, coarse = jamr.flag_by_mean_stddev(np.asarray(eta), refine,
                                             coarsen)
    if jm.elem_type == "MIXED":
        out = jadapt_ext.MixedConstrained.from_mesh(jm).refine_and_coarsen(
            flags, coarse, max_level=max_level)
        return out.mesh, out.prolong, out.constraints
    r = jadapt.adapt_flagged(jadapt.AdaptiveMesh(jm), flags, coarse,
                             max_level=max_level)
    return r.mesh, r.prolong, np.zeros((0, 3), np.int64)


def _hanging_err(u, cons):
    h, a, b = cons[:, 0], cons[:, 1], cons[:, 2]
    return float(np.abs(u[h] - 0.5 * (u[a] + u[b])).max() / np.abs(u).max())


@pytest.mark.parametrize("kind", ["mixed", "tet4"])
def test_hcc_driver_remeshing(kind, tmp_path, recorded):
    d = str(tmp_path)
    jm = (_mixed_case if kind == "mixed" else _tet4_case)(d)
    run = _run(d, lambda: coupled_hcc.run("input.dat", device="cpu"),
               vtu.ParaviewWriter)
    (m2, ind, r), = recorded["adapt"]
    deck = Deck(os.path.join(d, "input.dat"))
    rm, prolong, cons = _reference_remesh(
        jm, ind, deck("mesh/AMR/refine_percentage", 0.5),
        deck("mesh/AMR/coarsen_percentage", 0.5),
        deck("mesh/AMR/max_level", 3))
    assert np.array_equal(r.mesh.coords, rm.coords)
    assert np.array_equal(r.constraints, cons)
    assert (kind == "mixed") == (len(cons) > 0)
    assert (f"remeshing step 2: adapted to {rm.n_elems} elements"
            in run.stdout) and rm.n_elems > m2.n_elems
    # segments: steps 1-2 on the original mesh, 3-4 on the refined one
    (s1, _, n1, x0, u2), (s2, st3, n2, x2, u4) = recorded["rds"]
    assert (n1, n2) == (2, 2) and s2.mesh.n_elems == rm.n_elems
    gst = {k: v.numpy() for k, v in u2.items()}
    for k, v in st3.items():
        assert np.abs(v.numpy() - prolong(gst[k])).max() <= 0.0
    # both systems rebuilt on the reference's mesh from its prolongation
    pm = mesh_from_reference(rm)
    c = cons if len(cons) else None
    rds = common.make_rdc_system(pm, 3, hcc.hcc_blocks, deck, device="cpu",
                                 moving_mesh=True, constraints=c)
    want = rds.run_steps({k: torch.as_tensor(prolong(v))
                          for k, v in gst.items()}, 2,
                         params=coupled_hcc.load_params(deck),
                         coords=x2)[0]["u"].numpy()
    got = u4["u"].numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    fibres = np.zeros((pm.n_elems, 3))
    solid = solid_driver.make_solid(deck, pm, fibres, "cpu", c)
    x4 = solid.run_solver(x2, 0.04).x.numpy()
    xl = run.frames[-1][2]
    assert np.abs(xl - x4).max() <= 1e-12 * np.abs(x4).max()
    if c is not None:
        assert _hanging_err(got, cons) <= 1e-12
        assert _hanging_err(xl, cons) <= 1e-12
    with open(os.path.join(run.out, "out-4.vtu")) as f:
        cells = int(re.search(r'NumberOfCells="(\d+)"', f.read()).group(1))
    assert cells == rm.n_elems


def test_hcc_resumes_after_remeshing(tmp_path, monkeypatch):
    """The mixed run's checkpoint at step 2, written after remeshing,
    resumed: the last frame equals the uninterrupted run's."""
    d = str(tmp_path)
    _mixed_case(d, "checkpoint/step = 2\n")
    keep = tmp_path / "ck"
    os.makedirs(keep)
    save = coupled_hcc.save_checkpoint

    def keep_step_2(path, state, step, *a, **kw):
        save(path, state, step, *a, **kw)
        if step == 2:
            for name in ("checkpoint.npz", "checkpoint_mesh.msh"):
                shutil.copy(os.path.join(os.path.dirname(path), name), keep)

    monkeypatch.setattr(coupled_hcc, "save_checkpoint", keep_step_2)
    full = _run(d, lambda: coupled_hcc.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    ck = str(keep / "checkpoint.npz")
    with np.load(ck) as z:
        assert int(z["amr_done"]) == 1 and len(z["constraints"])
    with open(os.path.join(d, "input.dat"), "a") as f:
        f.write(f"checkpoint/resume = '{ck}'\n")
    resumed = _run(d, lambda: coupled_hcc.run("input.dat", device="cpu"),
                   vtu.ParaviewWriter)
    assert "resumed on remeshed grid (" in resumed.stdout
    assert f"resumed from {ck} at step 2" in resumed.stdout
    assert resumed.stdout.count(" ==== Step") == 2
    (t, fa, xa), (tb, fb, xb) = resumed.frames[-1], full.frames[-1]
    assert t == tb == 4
    assert np.abs(xa - xb).max() <= 1e-12 * np.abs(xb).max()
    for k in ("l", "c", "n", "p", "VM"):
        assert np.abs(fa[k] - fb[k]).max() <= 1e-12 * np.abs(fb[k]).max()
