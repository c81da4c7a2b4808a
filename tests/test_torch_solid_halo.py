"""The solid's Newton on several devices (rdcfes_tpu_torch/parallel/
solid_halo.py, SolidSystem(device_mesh=D)) and the solid and coupled HCC
drivers at `parallel/n_devices` > 1, on the CPU (`device="cpu"`: every
shard on the CPU):

* against the reference's HaloSolidSystem on the first 4 of the 8
  virtual devices (tests/conftest.py), box_hex_mesh(2), one load step:
  positions within 1e-8 and the same Newton iterations;
* against the port's single-device f64 SolidSystem on TET4, HEX8, TET10
  (within 1e-8) and MIXED (within 1e-6: the reference's bars, tests/
  test_halo.py:300-340, tests/test_tet10.py:320-340, tests/
  test_mixed.py:648-671), with the plan's memory contract (No_max <=
  2N/D, Gtot < N);
* the reference's notices and refusals: the f32 tangent's notice,
  ValueError for hanging-node constraints with device_mesh, and the
  solid driver's notice when a MixedMesh reaches a remeshing step at
  D > 1;
* `-s` (TET4) and `-c hcc` (MIXED) through cli.main at
  `parallel/n_devices = 2` against the one-device runs: every VTU field
  at the reference's multi-device bar (tests/test_drivers_multichip.py
  _run_both)."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as DeviceMesh

from rdcfes_tpu.systems import solid as jsolid
from rdcfes_tpu.solvers.newton import NewtonOptions as JNewtonOptions

from rdcfes_tpu_torch import cases, cli
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.mesh import (box_hex_mesh, box_mixed_mesh,
                                   box_tet_mesh, gmsh, tet4_to_tet10)
from rdcfes_tpu_torch.parallel import (HaloShardedSystem, HaloSolidSystem,
                                       ShardGroup)
from rdcfes_tpu_torch.solvers.newton import NewtonOptions
from rdcfes_tpu_torch.systems.solid import SolidSystem

from tests.test_torch_drivers import SOLID_DECK, _run, _same_frames
from tests.torch_helpers import quick_compile, reference_native_rcb, rel_l2

MATS = {0: {"young": 1.0e3, "poisson": 0.3}}
OPTS = dict(max_nonlinear_iterations=20, relative_residual_tolerance=1e-8)


def _kw(dz, penalty):
    return dict(materials=MATS, bcs={0: (0.0, 0.0, 0.0),
                                     5: (np.nan, np.nan, dz)},
                penalty=penalty)


def test_solid_halo_matches_reference(tmp_path):
    mesh = box_hex_mesh(2, 2, 2)
    kw = _kw(-0.05, 1.0e6)
    dmesh = DeviceMesh(np.array(jax.devices()[:4]), ("d",))
    with reference_native_rcb(tmp_path), quick_compile():
        ref = jsolid.SolidSystem(mesh, newton=JNewtonOptions(**OPTS),
                                 device_mesh=dmesh, **kw)
        want = ref.run_solver(np.asarray(ref.initial_positions()), 0.5)
    port = SolidSystem(mesh, newton=NewtonOptions(**OPTS), device_mesh=4,
                       device="cpu", **kw)
    assert isinstance(port._halo, HaloSolidSystem)
    np.testing.assert_array_equal(port._halo.plan.node_order,
                                  ref._halo.plan.node_order)
    got = port.run_solver(port.initial_positions(), 0.5)
    assert got.converged and bool(want.converged)
    assert got.iters == int(want.iters)
    assert rel_l2(got.x.numpy(), np.asarray(want.x)) <= 1e-8


@pytest.mark.parametrize("kind", ["tet4", "hex8", "tet10", "mixed"])
def test_solid_halo_matches_one_device(kind):
    mesh = {"tet4": lambda: box_tet_mesh(3, 3, 3),
            "hex8": lambda: box_hex_mesh(4, 4, 4),
            "tet10": lambda: tet4_to_tet10(box_tet_mesh(2, 2, 2)),
            "mixed": lambda: box_mixed_mesh(5, 3, 3)}[kind]()
    kw = (_kw(-0.05, 1.0e6) if kind in ("tet4", "hex8")
          else _kw(-0.3, 1.0e8))
    D = 4
    one = SolidSystem(mesh, newton=NewtonOptions(**OPTS), device="cpu",
                      **kw)
    multi = SolidSystem(mesh, newton=NewtonOptions(**OPTS),
                        device_mesh=ShardGroup(["cpu"] * D), device="cpu",
                        **kw)
    r1 = one.run_solver(one.initial_positions(), 0.5)
    rD = multi.run_solver(multi.initial_positions(), 0.5)
    assert r1.converged and rD.converged
    bar = 1e-6 if kind == "mixed" else 1e-8
    assert rel_l2(rD.x.numpy(), r1.x.numpy()) <= bar
    halo = multi._halo
    plan = halo.plan
    assert plan.D == D and plan.No_max <= 2.0 * mesh.n_nodes / D
    assert plan.Gtot < mesh.n_nodes
    # element tangents stay O(E/D) per shard
    assert max(sum(b["conn"].shape[0] for b in sh.blocks)
               for sh in halo.shards) <= 2.0 * mesh.n_elems / D
    if kind == "mixed":
        assert halo.face_types == ["QUAD4", "TRI3"]


def test_notices_and_refusals(tmp_path, monkeypatch, capsys):
    """The f32 tangent's notice (the halo Newton keeps f64), ValueError
    for hanging-node constraints with device_mesh, and the solid
    driver's notice at a remeshing step of a MixedMesh on 2 shards (the
    run goes on on the fixed mesh)."""
    mesh = box_hex_mesh(2, 2, 2)
    s = SolidSystem(mesh, MATS, {0: (0.0, 0.0, 0.0)}, device="cpu",
                    device_mesh=2, tangent_precision="f32")
    assert s.tangent_precision == "f64" and s._halo.plan.D == 2
    assert capsys.readouterr().out == (
        "solid: tangent_precision=f32 is single-chip only; multi-chip run "
        "keeps the f64 tangent\n")
    with pytest.raises(ValueError, match="single-chip only"):
        SolidSystem(mesh, MATS, {0: (0.0, 0.0, 0.0)}, device="cpu",
                    device_mesh=2, constraints=np.array([[0, 1, 2]]))
    monkeypatch.chdir(tmp_path)
    gmsh.write(box_mixed_mesh(3, 1, 1), "input.msh")
    with open("input.dat", "w") as f:
        f.write(SOLID_DECK.replace("output_time_points = ' 1 2 '",
                                   "output_time_points = ' 1 '")
                .replace("loading_step = 0.5", "loading_step = 1.0")
                + "remeshing_step = 1\nmesh/AMR/max_steps = 1\n"
                + "parallel/n_devices = 2\n")
    cli.main(["-s"], device="cpu")
    out = capsys.readouterr()
    assert ("remeshing step 1: mixed-element solid remeshing is "
            "single-chip only; continuing on the fixed mesh") in out.err
    assert "adapted to" not in out.out


def _cli_pair(tmp_path, write_case, argv, calls):
    """The case at 2 shards and on one device, both through cli.main;
    `calls` counts the halo systems' solves of each run."""
    runs = []
    for name, par in (("two", "parallel/n_devices = 2\n"), ("one", "")):
        d = str(tmp_path / name)
        os.makedirs(d)
        write_case(d, par)
        calls.clear()
        runs.append(_run(d, lambda: (cli.main(argv, device="cpu"),
                                     "simulation")[1],
                         vtu.ParaviewWriter))
        runs[-1] = (runs[-1], dict(calls))
    return runs


def _counted(calls, cls, name, monkeypatch):
    orig = getattr(cls, name)

    def counted(self, *a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return orig(self, *a, **kw)
    monkeypatch.setattr(cls, name, counted)


def test_solid_and_hcc_drivers_match_one_device(tmp_path, monkeypatch):
    def solid_case(d, par):
        gmsh.write(box_tet_mesh(2, 2, 2), os.path.join(d, "input.msh"))
        with open(os.path.join(d, "input.dat"), "w") as f:
            f.write(SOLID_DECK + par)

    def hcc_case(d, par):
        cases.make_hcc_case(d, n=2, n_steps=2, n_loading=1, mixed=True)
        with open(os.path.join(d, "input.dat"), "a") as f:
            f.write(par)

    calls = {}
    _counted(calls, HaloSolidSystem, "run_solver", monkeypatch)
    _counted(calls, HaloShardedSystem, "run_steps", monkeypatch)
    for tag, write, argv, want in (
            ("solid", solid_case, ["-s"], {"run_solver": 2}),
            ("hcc", hcc_case, ["-c", "hcc"],
             {"run_solver": 1, "run_steps": 2})):
        (two, c2), (one, c1) = _cli_pair(tmp_path / tag, write, argv, calls)
        assert c2 == want and c1 == {}
        assert len(one.frames) >= 2
        _same_frames(two, one)
