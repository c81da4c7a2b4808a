"""The port's PROTEAS and RIPF drivers and their CLI dispatch against
rdcfes_tpu's drivers, one reference run each, on box_tet_mesh(2,2,2) with
the decks of tests/test_drivers.py (PROTEAS's test_proteas_driver; RIPF's
test_ripf_scan_matches_per_step, which crosses the RT days and takes the
int-truncated maximum-dose fallback, with an output every step and
`checkpoint/step = 3`), both with `solver/linear/tolerance = 1e-14`: at
the default 3e-11 two correct Krylov solves stop about that far apart,
and the models carry the gap past the bars below.  The port runs with
`device="cpu"`; then:

* the processed `.msh`, the copied deck and IC files, the PVD and every
  VTU array that comes from the inputs are byte-equal, and the PROTEAS
  CSV is empty in both;
* RIPF's CSV rows (no header) agree within 1e-10 relative;
* the species handed to the VTU writer agree within 1e-10 relative L2 per
  field and frame; RIPF's time-derivative fields, which divide a
  difference of two states by dt, within 1e-8 of each field's largest
  magnitude; the RIPF total dose within 1e-15 of its largest value;
* the step banners and mesh summaries (stdout) and the unused-key
  warnings (stderr) are line-equal;
* the port's RIPF run in one-step segments (an output every step) and
  in one six-step segment (one `run_steps` call with the field_update
  hook) write the same bytes into the final VTU, as tests/test_drivers.py
  asserts of the reference's per-step and segment paths; at dt = 0.1,
  where ten additions of dt miss the day boundary at step 10, the port
  reads the dose at dt * step in both, so they agree there too;
* the reference's step-3 RIPF checkpoint, resumed in the port, ends
  within 1e-10 relative L2 of the uninterrupted run.

Range errors of RIPF's deck raise ValueError, a zero dose RuntimeError;
several devices and a MIXED mesh run to the end, and an entry point
without a card raises RuntimeError."""

import os
import shutil

import numpy as np
import pytest
import torch

import rdcfes_tpu.utils as jutils
from rdcfes_tpu.drivers import proteas as jproteas
from rdcfes_tpu.drivers import ripf as jripf
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.io.getpot import Deck as JDeck
from rdcfes_tpu.mesh import box_mixed_mesh, box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh

from rdcfes_tpu_torch import cases, cli
from rdcfes_tpu_torch.drivers import proteas, ripf
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.io.getpot import Deck

from tests.test_torch_drivers import (_arrays, _check_files, _check_species,
                                      _run, _same_frames, _summary_lines,
                                      _warnings)
from tests.torch_helpers import quick_compile

PROTEAS_DECK = """
directory = 'out'
input_GMSH = input.msh
input_nodal = input.nd
input_nodal_aux = input_aux.nd
time_step_number = 2
time_step = 0.01
output_step = 1
cells/total_capacity = 2.0
radiotherapy/max_dosage = 60.0
host/proliferation = 0.4
host/vsc_threshold = 0.05
tumour/diffusion = 0.1
tumour/diffusion_host = 0.05
tumour/proliferation = 0.5
tumour/vsc_threshold = 0.05
necrosis/slope = 2.0
oedema/diffusion = 0.1
solver/linear/tolerance = 1e-14
"""

RIPF_DECK = """
directory = 'out'
input_GMSH = input.msh
input_nodal = input.nodal
input_nodal_RT = input.rt
time_step_number = 6
time_step = 0.5
output_time_points = '{otp}'
RT_dose/broad/fractions = 2
RT_dose/focus/fractions = 2
volume_fraction/stroma = 0.30
volume_fraction/parenchyma = 0.20
volume_fraction/exponent = 2.5
volume_fraction/min_vacant = 1.e-5
HU/phi/tolerance = 1.0e-3
cc/delta = 0.0864
cc/delta/RT/a = 0.3
cc/delta/RT/b = 0.03
fb/lambda = 0.01
fb/omega = 0.1
fb/diffusion = 1.0e-20
fb/haptotaxis = 0.05
fb/radiotaxis = 0.01
solver/linear/tolerance = 1e-14
"""
EVERY_STEP = " 1 2 3 4 5 6 "
RIPF_SPECIES = ("HU", "cc", "fb")
RIPF_TD = ("HU_TimeDeriv", "cc_TimeDeriv", "fb_TimeDeriv")


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def _proteas_case(d, deck=PROTEAS_DECK):
    """test_proteas_driver's inputs; the IC file through the tolerant
    reader (a comment line and a blank line first)."""
    mesh = box_tet_mesh(2, 2, 2)
    rng = np.random.default_rng(3)
    u0 = np.stack([rng.uniform(0.2, 0.4, mesh.n_nodes),
                   rng.uniform(0.05, 0.2, mesh.n_nodes),
                   rng.uniform(0.0, 0.05, mesh.n_nodes),
                   rng.uniform(0.1, 0.2, mesh.n_nodes),
                   rng.uniform(0.0, 0.05, mesh.n_nodes)], axis=1)
    aux = np.stack([rng.uniform(-100, 100, mesh.n_nodes),
                    rng.uniform(0, 30, mesh.n_nodes)], axis=1)
    jgmsh.write(mesh, os.path.join(d, "input.msh"))
    rows = lambda a: "\n".join(" ".join(f"{v:.6g}" for v in r) for r in a)
    with open(os.path.join(d, "input.nd"), "w") as f:
        f.write("# header comment\n\n" + rows(u0))
    with open(os.path.join(d, "input_aux.nd"), "w") as f:
        f.write(rows(aux))
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(deck)
    return mesh, aux


def _ripf_case(d, otp=EVERY_STEP, extra="", rt_scale=1.0, deck=RIPF_DECK):
    """test_ripf_scan_matches_per_step's inputs."""
    mesh = box_tet_mesh(2, 2, 2)
    rng = np.random.default_rng(5)
    u0 = np.stack([rng.uniform(-500, -100, mesh.n_nodes),
                   rng.uniform(0.1, 0.3, mesh.n_nodes),
                   rng.uniform(0.1, 0.3, mesh.n_nodes)], axis=1)
    rt = rt_scale * np.stack([np.full(mesh.n_nodes, 56.0),
                              16.0 + 2.0 * rng.random(mesh.n_nodes)], axis=1)
    jgmsh.write(mesh, os.path.join(d, "input.msh"))
    np.savetxt(os.path.join(d, "input.nodal"), u0)
    np.savetxt(os.path.join(d, "input.rt"), rt)
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(deck.format(otp=otp) + extra)
    return mesh


@pytest.fixture(scope="module")
def proteas_runs(tmp_path_factory):
    dirs = [str(tmp_path_factory.mktemp(t)) for t in ("proteas_ref",
                                                      "proteas_port")]
    for d in dirs:
        _proteas_case(d)
    ref = _run(dirs[0], lambda: jproteas.run("input.dat"),
               jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: proteas.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    return ref, port


@pytest.fixture(scope="module")
def ripf_runs(tmp_path_factory):
    """(reference run, port run); both checkpoint every 3 steps, and the
    reference's step-3 checkpoint is kept as checkpoint-3.npz."""
    dirs = [str(tmp_path_factory.mktemp(t)) for t in ("ripf_ref",
                                                      "ripf_port")]
    for d in dirs:
        _ripf_case(d, extra="checkpoint/step = 3\n")
    keep = jutils.save_checkpoint

    def keep_each(path, state, step, *a, **kw):  # checkpoint-<step>.npz
        keep(path, state, step, *a, **kw)
        shutil.copy(path, path.replace(".npz", f"-{step}.npz"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "save_checkpoint", keep_each)
        ref = _run(dirs[0], lambda: jripf.run("input.dat"),
                   jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: ripf.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    return ref, port


def test_proteas_driver_matches_reference(proteas_runs):
    """Inputs byte-equal (HU and RTD in every VTU), the CSV empty in both,
    the five species within 1e-10 relative L2 per field and frame;
    banners and warnings line-equal."""
    ref, port = proteas_runs
    names = _check_files(ref, port, ["input.dat", "out.pvd", "out.csv"])
    assert [f"out-{t}.vtu" in names for t in range(3)] == [True] * 3
    assert os.path.getsize(os.path.join(port.out, "out.csv")) == 0
    _check_species(ref, port, ("hos", "tum", "nec", "vsc", "oed"))
    for (_, fa, _), (_, fb, _) in zip(ref.frames, port.frames):
        for name in ("HU", "RTD"):
            assert np.array_equal(fa[name], fb[name])
    for name in names:
        if name.endswith(".vtu"):
            a = _arrays(os.path.join(ref.out, name))
            b = _arrays(os.path.join(port.out, name))
            assert a["HU"] == b["HU"] and a["RTD"] == b["RTD"]
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    assert port.stdout.count(" ==== Step") == 2
    assert _warnings(port.stderr) == _warnings(ref.stderr)
    assert " Performance log: proteas" in port.stdout


@pytest.mark.parametrize("sampling", ["full", "reference"])
def test_proteas_rtd_at_qp(sampling, tmp_path):
    """The dose at the quadrature points, as the reference driver builds
    it (rdcfes_tpu/drivers/proteas.py:113-131): the P1 interpolation of
    RTD, or phi_1(qp) * HU(local node 1)."""
    from rdcfes_tpu.fem.elements import tabulate

    mesh, aux = _proteas_case(str(tmp_path))
    phi = tabulate("TET4")[0]
    conn = mesh.connectivity
    ref = (phi[:, 1][:, None] * aux[conn[:, 1], 0][None, :]
           if sampling == "reference"
           else np.einsum("qk,ek->qe", phi, aux[conn, 1]))
    out = proteas.rtd_at_qp(mesh, aux, sampling)
    assert out.shape == ref.shape == (len(phi), mesh.n_elems)
    assert np.array_equal(out, ref)


def test_ripf_driver_matches_reference(ripf_runs):
    """Inputs byte-equal (the two RT doses in every VTU), CSV rows within
    1e-10 relative, species within 1e-10 relative L2, the TD fields within
    1e-8 of each field's largest magnitude, the total dose within 1e-15;
    banners and warnings line-equal."""
    ref, port = ripf_runs
    names = _check_files(ref, port, ["output.msh", "input.dat",
                                     "input.nodal", "input.rt",
                                     "output4paraview.pvd"])
    assert [f"output4paraview-{t}.vtu" in names for t in range(7)] == [
        True] * 7
    a = open(os.path.join(ref.out, "output.csv")).read().splitlines()
    b = open(os.path.join(port.out, "output.csv")).read().splitlines()
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.array(y.split(","), dtype=float),
                                   np.array(x.split(","), dtype=float),
                                   rtol=1e-10, atol=0)
    _check_species(ref, port, RIPF_SPECIES)
    for (t, fa, _), (_, fb, _) in zip(ref.frames, port.frames):
        for name in RIPF_TD:
            tol = 1e-8 * max(np.abs(fa[name]).max(), 1e-300)
            assert np.abs(fb[name] - fa[name]).max() <= tol, (t, name)
        tot = fa["RT_dose/total"]
        assert np.abs(fb["RT_dose/total"] - tot).max() <= 1e-15 * np.abs(
            tot).max()
        for name in ("RT_dose/broad", "RT_dose/focus"):
            assert np.array_equal(fa[name], fb[name])
    # the dose grows over the days, and cc moves
    assert ref.frames[-1][1]["RT_dose/total"].max() > ref.frames[1][1][
        "RT_dose/total"].max()
    assert np.abs(ref.frames[-1][1]["cc_TimeDeriv"]).max() > 0
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    assert port.stdout.count(" ==== Step") == 6
    assert _warnings(port.stderr) == _warnings(ref.stderr)


def test_ripf_per_step_and_segment_paths_write_the_same_bytes(ripf_runs,
                                                              tmp_path):
    _, port = ripf_runs
    _ripf_case(str(tmp_path), otp=" 6 ")
    seg = _run(str(tmp_path), lambda: ripf.run("input.dat", device="cpu"),
               vtu.ParaviewWriter)
    assert [f[0] for f in seg.frames] == [0, 6]
    name = "output4paraview-6.vtu"
    assert open(os.path.join(seg.out, name)).read() == open(
        os.path.join(port.out, name)).read()
    csv = lambda r: open(os.path.join(r.out, "output.csv")).read(
        ).splitlines()
    assert csv(seg)[-1] == csv(port)[-1]


def test_ripf_time_is_dt_times_step_at_a_day_boundary(tmp_path):
    """dt = 0.1: step 10 is day 1, though ten additions of dt give
    0.9999999999999999 (day 0, what the reference's per-step path reads
    there).  Every step reads the dose at dt * step, so one-step segments
    and longer ones write the same bytes, and the total dose of frame 10
    is day 1's (RT_broad / fractions * 2)."""
    summed = 0.0
    for _ in range(10):
        summed += 0.1
    assert summed < 1.0 == 0.1 * 10
    deck = RIPF_DECK.replace("time_step_number = 6",
                             "time_step_number = 11").replace(
        "time_step = 0.5", "time_step = 0.1")
    runs = []
    for otp in (" 9 10 11 ", " 11 "):  # segments 9, 1, 1 and 11
        d = tmp_path / otp.strip().replace(" ", "_")
        d.mkdir()
        _ripf_case(str(d), otp=otp, deck=deck)
        runs.append(_run(str(d), lambda: ripf.run("input.dat", device="cpu"),
                         vtu.ParaviewWriter))
    name = "output4paraview-11.vtu"
    a, b = (open(os.path.join(r.out, name)).read() for r in runs)
    assert a == b
    frames = {t: f for t, f, _ in runs[0].frames}
    broad = frames[9]["RT_dose/broad"]
    assert np.array_equal(frames[9]["RT_dose/total"], broad / 2.0)
    assert np.array_equal(frames[10]["RT_dose/total"], broad / 2.0 * 2.0)


def test_ripf_reference_checkpoint_resumes_in_the_port(ripf_runs, tmp_path):
    """The reference's step-3 checkpoint (state, td, prev_raw) resumed in
    the port's driver ends within 1e-10 relative L2 of the port's
    uninterrupted run; the last checkpoints of the two runs agree."""
    from rdcfes_tpu_torch.utils.checkpoint import load_checkpoint

    ref, port = ripf_runs
    sa, ta, _, ea = load_checkpoint(os.path.join(ref.out, "checkpoint.npz"))
    sb, tb, _, eb = load_checkpoint(os.path.join(port.out, "checkpoint.npz"))
    assert ta == tb == 6 and sorted(ea) == sorted(eb) == ["prev_raw", "td"]
    for k in sa:
        assert np.linalg.norm(sb[k] - sa[k]) <= 1e-10 * np.linalg.norm(sa[k])
    ck = os.path.join(ref.out, "checkpoint-3.npz")
    _ripf_case(str(tmp_path), extra=f"checkpoint/step = 3\n"
                                    f"checkpoint/resume = '{ck}'\n")
    resumed = _run(str(tmp_path), lambda: ripf.run("input.dat",
                                                   device="cpu"),
                   vtu.ParaviewWriter)
    assert f"resumed from {ck} at step 3" in resumed.stdout
    assert [f[0] for f in resumed.frames] == [4, 5, 6]
    _, fr, _ = resumed.frames[-1]
    _, fp, _ = port.frames[-1]
    for name in RIPF_SPECIES:
        assert np.linalg.norm(fr[name] - fp[name]) <= \
            1e-10 * np.linalg.norm(fp[name]), name


@pytest.mark.parametrize("key,value", [
    ("volume_fraction/exponent", "-1"), ("HU/phi/cc/decay", "0.5"),
    ("cc/kappa", "-1.0"), ("cc/delta/RT/a", "0"),
    ("fb/lambda/HU/r", "0.0"), ("fb/omicro/fb/b", "1.5"),
])
def test_ripf_load_params_range_errors(key, value):
    """Each out-of-range value raises ValueError naming its key, as in the
    reference; a deck in range loads the reference's params."""
    base = {"cc/delta/RT/a": "0.3", "cc/delta/RT/b": "0.03"}
    assert ripf.load_params(Deck(base)) == jripf.load_params(JDeck(base))
    bad = {**base, key: value}
    with pytest.raises(ValueError, match=key):
        jripf.load_params(JDeck(bad))
    with pytest.raises(ValueError, match=f"out of range: {key} = "):
        ripf.load_params(Deck(bad))


def test_ripf_zero_dose_raises(tmp_path, monkeypatch, capsys):
    _ripf_case(str(tmp_path), rt_scale=0.0)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="maximum total RT dose <= 0"):
        ripf.run("input.dat", device="cpu")
    assert " ==== Step" not in capsys.readouterr().out


@pytest.mark.parametrize("driver", ["proteas", "ripf"])
@pytest.mark.parametrize("what", ["parallel", "mixed mesh"])
def test_unported_raise_before_any_step(driver, what, tmp_path,
                                        monkeypatch, capsys):
    """Several devices, which raised until they were ported, run the deck
    to its end with the frames of the one-device run (the halo system on
    2 shards; held to the reference in tests/
    test_torch_drivers_multichip.py); a MIXED mesh, which raised until it
    was ported, runs the deck to its end with finite species."""
    extra = "parallel/n_devices = 2\n" if what == "parallel" else ""
    if driver == "proteas":
        _proteas_case(str(tmp_path), PROTEAS_DECK + extra)
    else:
        _ripf_case(str(tmp_path), extra=extra)
    if what == "mixed mesh":
        mesh = box_mixed_mesh(3, 1, 1)
        jgmsh.write(mesh, str(tmp_path / "input.msh"))
        N, x = mesh.n_nodes, mesh.coords[:, 0]
        if driver == "proteas":
            rows = np.stack([0.3 - 0.1 * x, 0.1 + 0.1 * x, 0.02 * x,
                             np.full(N, 0.15), 0.02 * x], axis=1)
            np.savetxt(str(tmp_path / "input.nd"), rows)
            np.savetxt(str(tmp_path / "input_aux.nd"),
                       np.stack([50.0 * x, 20.0 + x], axis=1))
        else:
            np.savetxt(str(tmp_path / "input.nodal"),
                       np.stack([-300.0 + 0 * x, 0.1 + 0.1 * x,
                                 0.2 - 0.1 * x], axis=1))
            np.savetxt(str(tmp_path / "input.rt"),
                       np.stack([np.full(N, 56.0), 16.0 + x], axis=1))
    monkeypatch.chdir(tmp_path)
    mod = {"proteas": proteas, "ripf": ripf}[driver]
    if what == "parallel":
        one = tmp_path / "one"
        one.mkdir()
        if driver == "proteas":
            _proteas_case(str(one))
        else:
            _ripf_case(str(one))
        runs = [_run(d, lambda: mod.run("input.dat", device="cpu"),
                     vtu.ParaviewWriter) for d in (str(tmp_path), str(one))]
        n = {"proteas": 2, "ripf": 6}[driver]
        for r in runs:
            assert r.stdout.count(" ==== Step") == n
        assert len(runs[0].frames) > 1
        _same_frames(runs[0], runs[1])
        vtus = sorted(f for f in os.listdir(runs[0].out)
                      if f.endswith(".vtu"))
        pid = _arrays(os.path.join(runs[0].out, vtus[-1]))["processor_ID"]
        assert set(np.array(pid.split(), dtype=int)) == {0, 1}
        return
    out = _run(str(tmp_path), lambda: mod.run("input.dat", device="cpu"),
               vtu.ParaviewWriter)
    n = {"proteas": 2, "ripf": 6}[driver]
    assert out.stdout.count(" ==== Step") == n
    assert "elem_type=MIXED (" in out.stdout
    assert out.frames[-1][0] == n
    for _, f, _ in out.frames:
        assert all(np.isfinite(v).all() for v in f.values())


def test_generated_cases_run_through_the_cli(tmp_path, monkeypatch, capsys):
    """`-m proteas input=<file>` and `-m ripf` run their generated cases
    to the end: PROTEAS reads the named deck, RIPF `input.dat`."""
    d = cases.make_proteas_case(str(tmp_path / "p"), n=2, n_steps=4)
    os.rename(os.path.join(d, "input.dat"), os.path.join(d, "deck.dat"))
    monkeypatch.chdir(d)
    assert cli.main(["-m", "proteas", "input=deck.dat"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "Input file is: deck.dat" in out and out.count(" ==== Step") == 4
    assert sorted(os.listdir(os.path.join(d, "simulation"))) == [
        "deck.dat", "out-0.vtu", "out-1.vtu", "out-2.vtu", "out-3.vtu",
        "out-4.vtu", "out.pvd", "simulation.csv"]
    d = cases.make_ripf_case(str(tmp_path / "r"), n=2, n_steps=12)
    monkeypatch.chdir(d)
    assert cli.main(["-m", "ripf"], device="cpu") == 0
    assert capsys.readouterr().out.count(" ==== Step") == 12
    (res,) = [e for e in os.listdir(d) if os.path.isdir(os.path.join(d, e))]
    rows = open(os.path.join(d, res, "output.csv")).read().splitlines()
    assert len(rows) == 2 and rows[1].startswith("1,")
    last = _arrays(os.path.join(d, res, "Lung_Model-10.vtu"))
    hu = np.array(last["HU"].split(), dtype=float)
    assert np.isfinite(hu).all() and (np.abs(hu) <= 1000.0).all()


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    """device=None is the CUDA card: without one, RuntimeError, and no
    results directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _ripf_case(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    for fn in (proteas.run, ripf.run, lambda: cli.main(["-m", "ripf"]),
               lambda: cli.main(["-m", "proteas"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert not (tmp_path / "out").exists()
