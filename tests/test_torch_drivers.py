"""The port's PIHNA, ADPM and solid drivers and its CLI against
rdcfes_tpu's drivers, one reference run each (the decks of
tests/test_drivers.py; PIHNA's with `checkpoint/step = 1` and
`solver/linear/tolerance = 1e-14`: at the default 3e-11 the two
packages' Krylov solves stop at points that differ by about that
tolerance, and the deck's fast necrosis growth amplifies the gap past
1e-10 within three steps).  Each reference run and the port's run
(`device="cpu"`) go to their own directory; then:

* the processed `.msh`, the copied deck and IC files, the PVD and the CSV
  header are byte-equal, and so is every VTU array that comes from the
  inputs (Points where they are the mesh's, node_ID, HU, RT, the tracts,
  the undeformed coordinates, the reference fibres, the CellData,
  connectivity, offsets, types);
* CSV rows agree as numbers within 1e-10 relative;
* the fields handed to the VTU writer agree at full precision: transient
  species within 1e-10 relative L2 per field and frame; solid positions
  and displacements within 1e-10 of the displacement scale (the largest
  reference |u|); p, VM and the current fibres within 1e-8 of each
  field's largest magnitude;
* the step banners and mesh summaries (stdout) and the unused-key
  warnings (stderr) are line-equal, and the solid's Newton iteration
  counts equal;
* the reference's step-2 PIHNA checkpoint, resumed in the port's driver,
  ends within 1e-10 relative L2 of the port's uninterrupted run.

What the port does not run raises NotImplementedError before the first
step, and an entry point without a card raises RuntimeError."""

import io
import os
import re
import shutil
from contextlib import redirect_stderr, redirect_stdout
from typing import NamedTuple

import numpy as np
import pytest
import torch

import rdcfes_tpu.utils as jutils
from rdcfes_tpu.drivers import adpm as jadpm
from rdcfes_tpu.drivers import pihna as jpihna
from rdcfes_tpu.drivers import solid as jsolid
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import box_hex_mesh, box_mixed_mesh, box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh

from rdcfes_tpu_torch import cli
from rdcfes_tpu_torch.drivers import adpm, pihna, solid
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.io.getpot import Deck
from rdcfes_tpu_torch.utils.checkpoint import save_checkpoint

from tests.torch_helpers import quick_compile

PIHNA_DECK = """
directory = 'out'
input_GMSH = input.msh
input_nodal = input.nodal
input_elemental = input.elemental
time_step_number = 3
time_step = 0.1
output_step = 1
cells_max_capacity = 2.39e+5
cells_max_capacity/exponent = 3
cells_min_capacity = 1.0
cytokines_max_capacity = 1.0e-8
necrosis/c = 500.0
necrosis/h = 200.0
necrosis/v = 300.0
produce/c = -2.5
switch/c/to/h = 1.0
switch/h/to/c = 1.82
switch/h/to/n = 0.5
diffuse/v = 0.5
produce/v = 10.0
secrete/a/from/c = 2.77e-13
secrete/a/from/h = 5.22e-10
decay/a = 5678.4
checkpoint/step = 1
solver/linear/tolerance = 1e-14
"""

ADPM_DECK = """
directory = 'out'
input_GMSH = input.msh
input_nodal = input.nodal
input_elemental = input.elemental
time_step_number = 2
time_step = 0.05
output_step = 1
decay/PrP = 1.0e-4
decay/PrP/pulse/0 = 0.01
decay/PrP/pulse/1 = 10.0
diffuse/A_b = 0.05
diffuse/A_b/pulse/0 = 1e-5
diffuse/A_b/pulse/1 = 10.0
taxis/A_b = 999.0      # key mismatch on purpose: code reads taxis_1/A_b
"""

SOLID_DECK = """
directory = simulation
input_GMSH = input.msh
output_PARAVIEW = out
loading_step = 0.5
output_time_points = ' 1 2 '
solver/nonlinear/max_nonlinear_iterations = 10
BCs = ' 0 5 '
BC/0/displacement/0 = +0.000
BC/0/displacement/1 = +0.000
BC/0/displacement/2 = +0.000
BC/5/displacement/0 = NAN
BC/5/displacement/1 = NAN
BC/5/displacement/2 = -0.30
BCs/displacement_penalty = 1.e+8
materials = ' 0 '
material/0/Hyperelastic/Young = 1.0e+4
material/0/Hyperelastic/Poisson = 0.3
"""

# VTU arrays that come from the inputs, not from a solve
INPUT_ARRAYS = {"node_ID", "HU", "RT", "TractX", "TractY", "TractZ",
                "undeformed_x", "undeformed_y", "undeformed_z",
                "fibre_reference_x", "fibre_reference_y",
                "fibre_reference_z", "element_ID", "region_ID",
                "processor_ID", "connectivity", "offsets", "types"}
_ARRAY = re.compile(r'<DataArray type="\w+" Name="([^"]+)"[^>]*>\n(.*?)\n'
                    r"        </DataArray>", re.S)


class Run(NamedTuple):
    out: str        # results directory
    stdout: str
    stderr: str
    frames: list    # (t, {field: array}, coords or None) per VTU frame


def _write_case(d, mesh, deck_text, nodal=None, elemental=None):
    jgmsh.write(mesh, os.path.join(d, "input.msh"))
    if nodal is not None:
        np.savetxt(os.path.join(d, "input.nodal"), nodal)
    if elemental is not None:
        np.savetxt(os.path.join(d, "input.elemental"), elemental)
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(deck_text)


def _run(case_dir, fn, writer_cls) -> Run:
    """fn() in case_dir with stdout/stderr captured and every frame the
    driver hands its ParaviewWriter recorded at full precision."""
    frames = []
    orig = writer_cls.update_pvd

    def record(self, point_fields, t=0, **kw):
        coords = kw.get("coords")
        frames.append((t, {n: np.array(v, dtype=np.float64)
                           for n, v in point_fields},
                       None if coords is None else np.array(coords)))
        return orig(self, point_fields, t, **kw)

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(writer_cls, "update_pvd", record)
        mp.chdir(case_dir)
        with redirect_stdout(out), redirect_stderr(err):
            d = fn()
    return Run(os.path.join(case_dir, d), out.getvalue(), err.getvalue(),
               frames)


def _pihna_inputs():
    mesh = box_tet_mesh(3, 3, 3)
    rng = np.random.default_rng(0)
    Kk = 2.39e5
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 0.1 * Kk * rng.random(mesh.n_nodes)
    u0[:, 3] = 0.03 * Kk
    u0[:, 4] = 1e-9
    return mesh, u0, np.zeros((mesh.n_elems, 2))


@pytest.fixture(scope="module")
def pihna_runs(tmp_path_factory):
    """(reference run, port run); the reference's checkpoint of each step
    is kept as checkpoint-<step>.npz."""
    mesh, u0, structure = _pihna_inputs()
    dirs = [str(tmp_path_factory.mktemp(t)) for t in ("pihna_ref",
                                                      "pihna_port")]
    for d in dirs:
        _write_case(d, mesh, PIHNA_DECK, u0, structure)
    keep = jutils.save_checkpoint

    def keep_each(path, state, step, *a, **kw):  # checkpoint-<step>.npz
        keep(path, state, step, *a, **kw)
        shutil.copy(path, path.replace(".npz", f"-{step}.npz"))

    with quick_compile(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "save_checkpoint", keep_each)
        ref = _run(dirs[0], lambda: jpihna.run("input.dat"),
                   jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: pihna.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    return ref, port


@pytest.fixture(scope="module")
def adpm_runs(tmp_path_factory):
    mesh = box_tet_mesh(2, 2, 3)
    mesh.subdomain_id[: mesh.n_elems // 2] = 4
    mesh.subdomain_id[mesh.n_elems // 2:] = 9
    rng = np.random.default_rng(1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 0.1 * rng.random(mesh.n_nodes)
    tracts = rng.standard_normal((mesh.n_elems, 3))
    dirs = [str(tmp_path_factory.mktemp(t)) for t in ("adpm_ref",
                                                      "adpm_port")]
    for d in dirs:
        _write_case(d, mesh, ADPM_DECK, u0, tracts)
    with quick_compile():
        ref = _run(dirs[0], lambda: jadpm.run("input.dat"),
                   jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: adpm.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    return ref, port


@pytest.fixture(scope="module")
def solid_runs(tmp_path_factory):
    mesh = box_hex_mesh(3, 3, 3, bounds=((0, 1.5), (0, 1.5), (0, 1.5)))
    dirs = [str(tmp_path_factory.mktemp(t)) for t in ("solid_ref",
                                                      "solid_port")]
    for d in dirs:
        _write_case(d, mesh, SOLID_DECK)
    with quick_compile():
        ref = _run(dirs[0], lambda: jsolid.run("input.dat"),
                   jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: solid.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    return ref, port


def _arrays(path):
    with open(path) as f:
        return dict(_ARRAY.findall(f.read()))


def _summary_lines(text):
    """Mesh summaries and step banners: stdout before the phase log,
    without the solid's Newton lines."""
    head = text.split(" Performance log:")[0]
    return [ln for ln in head.splitlines()
            if ln.strip() and not ln.startswith("   Newton:")]


def _warnings(text):
    lines = text.splitlines()
    if "WARNING: input deck keys never consumed (typo? the reference " \
       "would silently use defaults):" not in lines:
        return []
    i = lines.index("WARNING: input deck keys never consumed (typo? the "
                    "reference would silently use defaults):")
    out = [lines[i]]
    for ln in lines[i + 1:]:
        if not ln.startswith("  "):
            break
        out.append(ln)
    return out


def _check_files(ref: Run, port: Run, byte_equal):
    listing = lambda d: sorted(n for n in os.listdir(d)
                               if not n.startswith("checkpoint-"))
    names = listing(ref.out)
    assert listing(port.out) == names
    for name in byte_equal:
        with open(os.path.join(ref.out, name), "rb") as a, \
                open(os.path.join(port.out, name), "rb") as b:
            assert a.read() == b.read(), name
    vtus = [n for n in names if n.endswith(".vtu")]
    assert len(vtus) == len(ref.frames) == len(port.frames)
    for name in vtus:
        a = _arrays(os.path.join(ref.out, name))
        b = _arrays(os.path.join(port.out, name))
        assert list(a) == list(b), name  # the same arrays in the same order
        for key in INPUT_ARRAYS & set(a):
            assert a[key] == b[key], (name, key)
    return names


def _check_csv(ref: Run, port: Run, name="output.csv"):
    a = open(os.path.join(ref.out, name)).read().splitlines()
    b = open(os.path.join(port.out, name)).read().splitlines()
    assert a[0] == b[0] and len(a) == len(b)
    for x, y in zip(a[1:], b[1:]):
        x = np.array(x.split(","), dtype=float)
        y = np.array(y.split(","), dtype=float)
        np.testing.assert_allclose(y, x, rtol=1e-10, atol=0)
    return a


def _check_species(ref: Run, port: Run, names):
    assert [f[0] for f in ref.frames] == [f[0] for f in port.frames]
    for (t, fa, _), (_, fb, _) in zip(ref.frames, port.frames):
        for name in names:
            x, y = fa[name], fb[name]
            assert np.isfinite(y).all()
            scale = np.linalg.norm(x)
            err = np.linalg.norm(y - x)
            assert err <= 1e-10 * scale or (scale == 0 and err == 0), \
                (t, name, err / max(scale, 1e-300))


def test_pihna_driver_matches_reference(pihna_runs):
    """Files byte-equal where they come from inputs, CSV rows within
    1e-10 relative, the five species within 1e-10 relative L2 per field
    and frame."""
    ref, port = pihna_runs
    names = _check_files(ref, port, [
        "output.msh", "input.dat", "input.nodal", "input.elemental",
        "output4paraview.pvd"])
    assert [f"output4paraview-{t}.vtu" in names for t in range(4)] == [
        True] * 4
    rows = _check_csv(ref, port)
    assert len(rows) == 5
    _check_species(ref, port, ("n", "c", "h", "v", "a"))
    for (_, fa, _), (_, fb, _) in zip(ref.frames, port.frames):
        assert np.array_equal(fa["HU"], fb["HU"])


def test_pihna_banners_and_warnings_match_reference(pihna_runs):
    ref, port = pihna_runs
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    assert port.stdout.count(" ==== Step") == 3
    assert _warnings(port.stderr) == _warnings(ref.stderr)
    assert " Performance log: pihna" in port.stdout


def test_pihna_checkpoints_cross_packages(pihna_runs, tmp_path):
    """The last checkpoint of each run agrees within 1e-10 relative L2
    per array, and the reference's step-2 checkpoint, resumed in the
    port's driver, ends within 1e-10 of the port's uninterrupted run."""
    from rdcfes_tpu.utils import load_checkpoint as jload

    from rdcfes_tpu_torch.utils.checkpoint import load_checkpoint

    ref, port = pihna_runs
    sa, ta, _, _ = jload(os.path.join(port.out, "checkpoint.npz"))
    sb, tb, _, _ = load_checkpoint(os.path.join(ref.out, "checkpoint.npz"))
    assert ta == tb == 3 and sorted(sa) == sorted(sb) == [
        "u", "u_old", "u_older", "u_raw"]
    for k in sa:
        assert np.linalg.norm(sa[k] - sb[k]) <= 1e-10 * np.linalg.norm(sb[k])

    mesh, u0, structure = _pihna_inputs()
    ck = os.path.join(ref.out, "checkpoint-2.npz")
    _write_case(str(tmp_path), mesh,
                PIHNA_DECK + f"checkpoint/resume = '{ck}'\n", u0, structure)
    resumed = _run(str(tmp_path), lambda: pihna.run("input.dat",
                                                    device="cpu"),
                   vtu.ParaviewWriter)
    assert f"resumed from {ck} at step 2" in resumed.stdout
    assert [f[0] for f in resumed.frames] == [3]
    t, fr, _ = resumed.frames[0]
    _, fp, _ = port.frames[-1]
    for name in ("n", "c", "h", "v", "a"):
        assert np.linalg.norm(fr[name] - fp[name]) <= \
            1e-10 * np.linalg.norm(fp[name]), name
    csv = open(os.path.join(resumed.out, "output.csv")).read().splitlines()
    assert len(csv) == 2 and csv[1].startswith("0.3,")


def test_adpm_driver_matches_reference(adpm_runs):
    """Files byte-equal where they come from inputs (tracts included),
    CSV rows within 1e-10 relative, the three species within 1e-10
    relative L2 per field and frame, and the misspelled `taxis/A_b`
    reported unused exactly as the reference reports it."""
    ref, port = adpm_runs
    _check_files(ref, port, ["output.msh", "input.dat", "input.nodal",
                             "input.elemental", "output4paraview.pvd"])
    rows = _check_csv(ref, port)
    assert len(rows) == 4 and "CONCENTRATION__A_b__4" in rows[0]
    _check_species(ref, port, ("PrP", "A_b", "Tau"))
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    warn = _warnings(port.stderr)
    assert warn == _warnings(ref.stderr) and warn[1:] == [
        "  taxis/A_b = 999.0"]


def test_solid_driver_matches_reference(solid_runs):
    """Positions (the Points too) and displacements within 1e-10 of the
    displacement scale; p, VM and the current fibres within 1e-8 of each
    field's largest magnitude; inputs byte-equal; banners equal and the
    Newton iteration counts equal."""
    ref, port = solid_runs
    _check_files(ref, port, ["output.msh", "input.dat", "out.pvd"])
    assert [f[0] for f in ref.frames] == [f[0] for f in port.frames] == [
        0, 1, 2]
    u_scale = np.abs(np.stack([f[1][n] for f in ref.frames
                               for n in ("u_x", "u_y", "u_z")])).max()
    for (t, fa, xa), (_, fb, xb) in zip(ref.frames, port.frames):
        assert np.abs(xb - xa).max() <= 1e-10 * u_scale, t
        for n in ("x", "y", "z", "u_x", "u_y", "u_z"):
            assert np.abs(fb[n] - fa[n]).max() <= 1e-10 * u_scale, (t, n)
        for n in ("p", "VM", "fibre_current_x", "fibre_current_y",
                  "fibre_current_z"):
            tol = 1e-8 * np.abs(fa[n]).max()
            assert np.abs(fb[n] - fa[n]).max() <= tol, (t, n)
        for n in ("undeformed_x", "fibre_reference_x"):
            assert np.array_equal(fa[n], fb[n])
    assert u_scale > 0.1  # the top face moved
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    newton = lambda s: re.findall(r"Newton: (\d+) iterations", s)
    assert newton(port.stdout) == newton(ref.stdout) and len(
        newton(ref.stdout)) == 2
    assert _warnings(port.stderr) == _warnings(ref.stderr)


def test_solid_precision_follows_the_device():
    """On the card a mixed Krylov and an f32 tangent, on the CPU f64; the
    deck keys override; `solver/linear/fast_gather` is consumed."""
    d = Deck({})
    assert solid.load_newton_options(d, "cuda").linear_precision == "mixed"
    assert solid.load_newton_options(d, "cpu").linear_precision == "f64"
    assert solid.load_tangent_precision(d, torch.device("cuda")) == "f32"
    assert solid.load_tangent_precision(d, "cpu") == "f64"
    d = Deck({"solver/linear/precision": "f64",
              "solver/nonlinear/tangent_precision": "f64",
              "solver/linear/fast_gather": "1"})
    assert solid.load_newton_options(d, "cuda").linear_precision == "f64"
    assert solid.load_tangent_precision(d, "cuda") == "f64"
    assert d.unused_keys() == []


def _tiny_pihna_case(d, extra=""):
    mesh = box_tet_mesh(1, 1, 2)
    _write_case(str(d), mesh, PIHNA_DECK.replace("checkpoint/step = 1\n", "")
                + extra, np.full((mesh.n_nodes, 5), 1.0),
                np.zeros((mesh.n_elems, 2)))


@pytest.mark.parametrize("extra", [
    "refinement_step = 2\nmesh/AMR/max_steps = 1\n",
    "parallel/n_devices = 2\n",
    "mixed mesh",
    "amr checkpoint",
])
def test_pihna_unported_raise_before_any_step(extra, tmp_path, monkeypatch,
                                              capsys):
    """AMR within the run, several devices, a MIXED mesh and a checkpoint
    written after AMR each raise NotImplementedError before a step."""
    if extra == "mixed mesh":
        _tiny_pihna_case(tmp_path)
        jgmsh.write(box_mixed_mesh(3, 1, 1), str(tmp_path / "input.msh"))
    elif extra == "amr checkpoint":
        ck = str(tmp_path / "ck.npz")
        _tiny_pihna_case(tmp_path, f"checkpoint/resume = '{ck}'\n")
        deck = Deck(str(tmp_path / "input.dat"))
        save_checkpoint(ck, {"u": np.ones((12, 5))}, 1, 0.1,
                        pihna.load_params(deck), amr_done=np.asarray(1))
    else:
        _tiny_pihna_case(tmp_path, extra)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        pihna.run("input.dat", device="cpu")
    assert " ==== Step" not in capsys.readouterr().out


def test_adpm_and_solid_unported_raise(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mesh = box_hex_mesh(1, 1, 1)
    _write_case(str(tmp_path), mesh, ADPM_DECK + "parallel/n_devices = 4\n",
                np.ones((mesh.n_nodes, 3)), np.ones((mesh.n_elems, 3)))
    with pytest.raises(NotImplementedError, match="item 14"):
        adpm.run("input.dat", device="cpu")
    for extra, item in (("parallel/n_devices = 2\n", "item 14"),
                        ("remeshing_step = 1\nmesh/AMR/max_steps = 1\n",
                         "item 13")):
        _write_case(str(tmp_path), mesh, SOLID_DECK + extra)
        with pytest.raises(NotImplementedError, match=item):
            solid.run("input.dat", device="cpu")
    assert " ==== Step" not in capsys.readouterr().out
    # a remeshing step without AMR steps runs on, with the reference's NOTE
    _write_case(str(tmp_path), mesh, SOLID_DECK.replace(
        "loading_step = 0.5", "loading_step = 1.0").replace(
        "' 1 2 '", "' 1 '") + "remeshing_step = 1\n")
    solid.run("input.dat", device="cpu")
    assert "NOTE: remeshing step reached but mesh/AMR/max_steps = 0" in \
        capsys.readouterr().err


def test_cli_dispatch(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for argv in (["-m", "ripf"], ["-m", "proteas"], ["-c", "hcc"],
                 ["-u", "process_mesh"]):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            cli.main(argv, device="cpu")
    for argv in (["-x"], [], ["-m", "nonsense"], ["-m"], ["-c", "x"],
                 ["-u", "x"]):
        assert cli.main(argv, device="cpu") == 1
    _tiny_pihna_case(tmp_path)
    assert cli.main(["-m", "pihna"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "Input file is: input.dat" in out and out.count(" ==== Step") == 3
    assert len(os.listdir(tmp_path / "out")) == 10  # 4 VTU, PVD, CSV, ...


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    """device=None is the CUDA card: without one, RuntimeError, never the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    _tiny_pihna_case(tmp_path)
    for fn in (pihna.run, adpm.run, solid.run,
               lambda: cli.main(["-m", "pihna"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert not (tmp_path / "out").exists()
