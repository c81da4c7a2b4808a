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

Several devices run the ADPM and solid decks to the one-device runs'
frames, and an entry point without a card raises RuntimeError."""

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

import rdcfes_tpu_torch.mesh as pmesh
from rdcfes_tpu_torch import cli
from rdcfes_tpu_torch.drivers import adpm, coupled_hcc, pihna, solid
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.io.getpot import Deck
from rdcfes_tpu_torch.mesh import gmsh as pgmsh
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


def _same_frames(a: Run, b: Run) -> None:
    """Two runs' frames equal at the multi-device bar of the reference's
    tests/test_drivers_multichip.py: rtol 1e-8, atol 1e-8 (1 + max|b|)
    per field."""
    assert [t for t, _, _ in a.frames] == [t for t, _, _ in b.frames]
    for (_, fa, _), (_, fb, _) in zip(a.frames, b.frames):
        assert fa.keys() == fb.keys()
        for k in fb:
            np.testing.assert_allclose(
                fa[k], fb[k], rtol=1e-8,
                atol=1e-8 * (1.0 + np.abs(fb[k]).max()), err_msg=k)


def _keep_each(save):
    """save_checkpoint that also keeps checkpoint-<step>.npz."""
    def keep(path, state, step, *a, **kw):
        save(path, state, step, *a, **kw)
        shutil.copy(path, path.replace(".npz", f"-{step}.npz"))
    return keep


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
    with quick_compile(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "save_checkpoint",
                   _keep_each(jutils.save_checkpoint))
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


# ----------------------------------------------------------------------
# PIHNA with AMR (the reference's tests/test_drivers.py:487 case, on a
# box whose refined nodes the Gmsh writer's 6 digits keep exactly)
# ----------------------------------------------------------------------
AMR_DECK = PIHNA_DECK + """refinement_step = 2
mesh/AMR/max_steps = 1
mesh/AMR/strategy = {strategy}
"""


def _amr_inputs(mesh):
    Kk = 2.39e5
    u0 = np.zeros((mesh.n_nodes, 5))
    mid = mesh.coords.mean(axis=0)
    r2 = ((mesh.coords - mid) ** 2).sum(axis=1)
    u0[:, 1] = 0.05 * Kk * np.exp(-r2 / 0.1)  # a localised seed: jumps
    u0[:, 3] = 0.03 * Kk
    u0[:, 4] = 1e-9
    structure = np.random.default_rng(2).random((mesh.n_elems, 2))
    return u0, structure


@pytest.fixture(scope="module", params=["bisection", "1to8"])
def pihna_amr_runs(request, tmp_path_factory):
    """(reference run, port run) of 3 steps with AMR at step 2, each
    step's checkpoint kept."""
    strategy = request.param
    mesh = box_tet_mesh(3, 3, 3, bounds=((0, 1.5),) * 3)
    u0, structure = _amr_inputs(mesh)
    dirs = [str(tmp_path_factory.mktemp(f"amr_{strategy}_{t}"))
            for t in ("ref", "port")]
    for d in dirs:
        _write_case(d, mesh, AMR_DECK.format(strategy=strategy), u0,
                    structure)
    with quick_compile(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "save_checkpoint",
                   _keep_each(jutils.save_checkpoint))
        ref = _run(dirs[0], lambda: jpihna.run("input.dat"),
                   jvtu.ParaviewWriter)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pihna, "save_checkpoint", _keep_each(save_checkpoint))
        port = _run(dirs[1], lambda: pihna.run("input.dat", device="cpu"),
                    vtu.ParaviewWriter)
    return strategy, mesh, ref, port


def test_pihna_amr_driver_matches_reference(pihna_amr_runs):
    """The refined mesh (processed copy and checkpoint mesh byte-equal),
    the carried structure (HU, RT), the CSV rows within 1e-10 relative,
    the species within 1e-10 relative L2 per field and frame, the
    checkpoint's AMR arrays equal, and the banners with the AMR line."""
    strategy, mesh, ref, port = pihna_amr_runs
    names = _check_files(ref, port, [
        "output.msh", "input.dat", "output4paraview.pvd",
        "checkpoint_mesh.msh"])
    assert "checkpoint_mesh.msh" in names
    _check_csv(ref, port)
    _check_species(ref, port, ("n", "c", "h", "v", "a"))
    for (_, fa, _), (_, fb, _) in zip(ref.frames, port.frames):
        np.testing.assert_allclose(fb["HU"], fa["HU"], rtol=1e-15, atol=0)
        np.testing.assert_allclose(fb["RT"], fa["RT"], rtol=1e-15, atol=0)
    n_last = len(port.frames[-1][1]["c"])
    assert mesh.n_nodes < n_last
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    amr_line = [ln for ln in port.stdout.splitlines()
                if ln.startswith("AMR step 2: adapted to")]
    assert len(amr_line) == 1
    assert ("hanging nodes" in amr_line[0]) == (strategy == "1to8")
    assert re.search(r"^ amr +1 ", port.stdout, re.M)
    a = np.load(os.path.join(ref.out, "checkpoint.npz"))
    b = np.load(os.path.join(port.out, "checkpoint.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert int(b["amr_done"]) == 1
    np.testing.assert_allclose(b["structure"], a["structure"], rtol=1e-15)
    if strategy == "1to8":
        assert len(b["constraints"])
        assert np.array_equal(a["constraints"], b["constraints"])
        u = port.frames[-1][1]
        h, ia, ib = b["constraints"].T
        for name in ("n", "c", "h", "v", "a"):
            np.testing.assert_allclose(u[name][h],
                                       0.5 * (u[name][ia] + u[name][ib]),
                                       rtol=1e-12, atol=0)


def test_pihna_amr_resume_equals_uninterrupted(pihna_amr_runs, tmp_path):
    """The reference's step-2 checkpoint, written after AMR, resumed in
    the port's driver on the refined mesh (with its hanging nodes under
    1to8), ends within 1e-12 of the port's uninterrupted run; the
    port's own step-2 checkpoint resumes to the same frame."""
    strategy, mesh, ref, port = pihna_amr_runs
    u0, structure = _amr_inputs(mesh)
    last = port.frames[-1][1]
    for i, src in enumerate((ref.out, port.out)):
        d = tmp_path / f"resume{i}"
        d.mkdir()
        ck = os.path.join(src, "checkpoint-2.npz")
        _write_case(str(d), mesh, AMR_DECK.format(strategy=strategy)
                    + f"checkpoint/resume = '{ck}'\n", u0, structure)
        resumed = _run(str(d), lambda: pihna.run("input.dat", device="cpu"),
                       vtu.ParaviewWriter)
        assert "resumed on AMR mesh" in resumed.stdout
        assert [f[0] for f in resumed.frames] == [3]
        fr = resumed.frames[0][1]
        for name in ("n", "c", "h", "v", "a"):
            assert np.linalg.norm(fr[name] - last[name]) <= \
                1e-12 * np.linalg.norm(last[name]), (src, name)


def test_pihna_amr_hex8_matches_reference_refinement(tmp_path, monkeypatch):
    """HEX8 refines uniformly where anything is flagged: the port's
    driver state right after its AMR step equals the reference's Kelly,
    flags, refine_flagged and prolongation applied to the port's state
    before it (a reference HEX8 PIHNA step program takes about a minute
    to compile, so the steps themselves are held to the reference by
    tests/test_torch_generic.py), and the refined mesh's file is the
    reference writer's."""
    from rdcfes_tpu.fem import amr as jamr
    from rdcfes_tpu.mesh import refine_flagged as jrefine_flagged

    mesh = box_hex_mesh(2, 2, 2, bounds=((0, 1.5),) * 3)
    u0, structure = _amr_inputs(mesh)
    saved = {}
    monkeypatch.setattr(pihna, "save_checkpoint",
                        _keep_each(save_checkpoint))
    for name, deck in (("plain", PIHNA_DECK),
                       ("amr", AMR_DECK.format(strategy="bisection"))):
        d = tmp_path / name
        d.mkdir()
        _write_case(str(d), mesh, deck, u0, structure)
        saved[name] = _run(str(d), lambda: pihna.run("input.dat",
                                                     device="cpu"),
                           vtu.ParaviewWriter)
    before = np.load(os.path.join(saved["plain"].out, "checkpoint-2.npz"))
    after = np.load(os.path.join(saved["amr"].out, "checkpoint-2.npz"))
    eta = jamr.kelly_error_indicator(mesh, before["u"], list(range(5)))
    flags, _ = jamr.flag_by_mean_stddev(eta, 0.5, 0.5)
    r = jrefine_flagged(mesh, flags)
    assert r is not None and r.mesh.n_elems == 8 * mesh.n_elems
    for k in ("u", "u_old", "u_older", "u_raw"):
        np.testing.assert_allclose(after[k], r.prolong(before[k]),
                                   rtol=1e-15, atol=0)
    np.testing.assert_array_equal(after["structure"],
                                  r.restrict_elemental(structure))
    with open(os.path.join(saved["amr"].out, "checkpoint_mesh.msh")) as f:
        assert f.read() == jgmsh.dumps(r.mesh)
    assert len(saved["amr"].frames[-1][1]["c"]) == r.mesh.n_nodes


def _tiny_pihna_case(d, extra=""):
    mesh = box_tet_mesh(1, 1, 2)
    _write_case(str(d), mesh, PIHNA_DECK.replace("checkpoint/step = 1\n", "")
                + extra, np.full((mesh.n_nodes, 5), 1.0),
                np.zeros((mesh.n_elems, 2)))


@pytest.mark.parametrize("extra", [
    "parallel/n_devices = 2\n",
    "mixed mesh",
])
def test_pihna_unported_raise_before_any_step(extra, tmp_path, monkeypatch,
                                              capsys):
    """Several devices, which raised until they were ported, run: the
    tiny case on 2 shards gives the one-device run's frames and each
    element's shard in the VTU (held to the reference in tests/
    test_torch_drivers_multichip.py); AMR on a MIXED mesh, which raised
    until it was ported, runs: its TET4 block refines at step 2 against
    the HEX8 and PYRAMID5 blocks."""
    if extra == "mixed mesh":
        _tiny_pihna_case(tmp_path, "refinement_step = 2\n"
                         "mesh/AMR/max_steps = 1\n")
        mesh = box_mixed_mesh(3, 1, 1)
        jgmsh.write(mesh, str(tmp_path / "input.msh"))
        x = mesh.coords[:, 0]
        np.savetxt(str(tmp_path / "input.nodal"),
                   np.stack([1.0 + x * (k + 1) for k in range(5)], axis=1))
        np.savetxt(str(tmp_path / "input.elemental"),
                   np.zeros((mesh.n_elems, 2)))
    else:
        _tiny_pihna_case(tmp_path, extra)
    monkeypatch.chdir(tmp_path)
    if extra != "mixed mesh":
        one = tmp_path / "one"
        one.mkdir()
        _tiny_pihna_case(one)
        runs = [_run(d, lambda: pihna.run("input.dat", device="cpu"),
                     vtu.ParaviewWriter) for d in (str(tmp_path), str(one))]
        assert [t for t, _, _ in runs[0].frames] == [0, 1, 2, 3]
        _same_frames(runs[0], runs[1])
        pid = _arrays(os.path.join(runs[0].out, "output4paraview-3.vtu"))[
            "processor_ID"]
        assert set(np.array(pid.split(), dtype=int)) == {0, 1}
        return
    out = pihna.run("input.dat", device="cpu")
    text = capsys.readouterr().out
    assert "AMR step 2: adapted to " in text and "hanging nodes" in text
    assert " ==== Step    3 out of    3" in text
    c = _arrays(os.path.join(out, "output4paraview-3.vtu"))["c"]
    assert np.isfinite(np.array(c.split(), dtype=float)).all()


@pytest.mark.parametrize("extra", [
    "refinement_step = 2\nmesh/AMR/max_steps = 1\n",
    "amr checkpoint",
])
def test_pihna_amr_cases_run(extra, tmp_path, monkeypatch, capsys):
    """What raised before AMR was ported runs: an AMR step within the run
    (the tiny case's 6 TET4 split by bisection), and a resume from a
    checkpoint written after AMR, onto its refined mesh."""
    monkeypatch.chdir(tmp_path)
    if extra == "amr checkpoint":
        mesh = box_tet_mesh(1, 1, 2)
        refined = pmesh.refine_uniform(pmesh.box_tet_mesh(1, 1, 2)).mesh
        ck = str(tmp_path / "ck.npz")
        _tiny_pihna_case(tmp_path, f"checkpoint/resume = '{ck}'\n")
        deck = Deck(str(tmp_path / "input.dat"))
        u = np.ones((refined.n_nodes, 5))
        pgmsh.write(refined, str(tmp_path / "checkpoint_mesh.msh"))
        save_checkpoint(ck, {k: u for k in ("u", "u_old", "u_older",
                                             "u_raw")}, 1, 0.1,
                        pihna.load_params(deck), amr_done=np.asarray(1),
                        structure=np.zeros((refined.n_elems, 2)))
        out = pihna.run("input.dat", device="cpu")
        text = capsys.readouterr().out
        assert f"resumed on AMR mesh ({refined.n_elems} elements)" in text
        assert mesh.n_elems < refined.n_elems
    else:
        _tiny_pihna_case(tmp_path, extra)
        out = pihna.run("input.dat", device="cpu")
        text = capsys.readouterr().out
        assert "AMR step 2: " in text
    assert " ==== Step    3 out of    3" in text
    c = _arrays(os.path.join(out, "output4paraview-3.vtu"))["c"]
    assert np.isfinite(np.array(c.split(), dtype=float)).all()


def test_adpm_and_solid_unported_raise(tmp_path, monkeypatch, capsys):
    """ADPM and the solid on several devices, which raised until they
    were ported, run (the one HEX8 element on shard 0, the other shards
    empty) to the one-device runs' frames."""
    monkeypatch.chdir(tmp_path)
    mesh = box_hex_mesh(1, 1, 1)
    u0 = 1.0 + 0.1 * np.arange(mesh.n_nodes * 3).reshape(-1, 3) / 24
    for deck, fn, args in ((ADPM_DECK, adpm.run,
                            (u0, np.ones((mesh.n_elems, 3)))),
                           (SOLID_DECK, solid.run, ())):
        runs = []
        for d, extra in ((tmp_path / f"four_{fn.__module__}",
                          "parallel/n_devices = 4\n"),
                         (tmp_path / f"one_{fn.__module__}", "")):
            d.mkdir()
            _write_case(str(d), mesh, deck + extra, *args)
            runs.append(_run(str(d), lambda: fn("input.dat", device="cpu"),
                             vtu.ParaviewWriter))
        assert len(runs[0].frames) > 1
        _same_frames(runs[0], runs[1])
    # remeshing runs (held to the reference in tests/test_torch_solid_ext
    # .py); two elements share their one interior face, so their Kelly
    # indicators are equal and none is flagged
    _write_case(str(tmp_path), box_hex_mesh(2, 1, 1), SOLID_DECK
                + "remeshing_step = 1\nmesh/AMR/max_steps = 1\n")
    solid.run("input.dat", device="cpu")
    out = capsys.readouterr().out
    assert "remeshing step 1: nothing flagged" in out
    assert " ==== Step    2 out of    2" in out
    # a remeshing step without AMR steps runs on, with the reference's NOTE
    _write_case(str(tmp_path), mesh, SOLID_DECK.replace(
        "loading_step = 0.5", "loading_step = 1.0").replace(
        "' 1 2 '", "' 1 '") + "remeshing_step = 1\n")
    solid.run("input.dat", device="cpu")
    assert "NOTE: remeshing step reached but mesh/AMR/max_steps = 0" in \
        capsys.readouterr().err


def test_cli_dispatch(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    # -m proteas, -m ripf, -c hcc and -u process_mesh reach their drivers;
    # only PROTEAS takes the deck of input=<file>, and process_mesh (host
    # only, stdin prompts) no device
    from rdcfes_tpu_torch import drivers

    calls = []
    for name in ("proteas", "ripf", "coupled_hcc", "process_mesh"):
        monkeypatch.setattr(getattr(drivers, name), "run",
                            lambda *a, _n=name, **kw: calls.append(
                                (_n, a, kw)))
    assert cli.main(["-m", "proteas", "input=deck.dat"], device="cpu") == 0
    assert cli.main(["-m", "proteas"], device="cpu") == 0
    assert cli.main(["-m", "ripf", "input=deck.dat"], device="cpu") == 0
    assert cli.main(["-c", "hcc"], device="cpu") == 0
    assert cli.main(["-u", "process_mesh"], device="cpu") == 0
    assert calls == [("proteas", ("deck.dat",), {"device": "cpu"}),
                     ("proteas", ("input.dat",), {"device": "cpu"}),
                     ("ripf", (), {"device": "cpu"}),
                     ("coupled_hcc", (), {"device": "cpu"}),
                     ("process_mesh", (), {})]
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
    for fn in (pihna.run, adpm.run, solid.run, coupled_hcc.run,
               lambda: cli.main(["-m", "pihna"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert not (tmp_path / "out").exists()
