"""The port's drivers with `parallel/n_devices` > 1 (the halo system of
rdcfes_tpu_torch/parallel/halo.py, every shard on the CPU here):

* the PIHNA driver on make_pihna_case(n=3) at 8 shards against the
  reference's driver at 8 virtual devices (tests/conftest.py), both with
  `solver/linear/tolerance = 1e-14`: CSV rows within 1e-10 relative, the
  VTU species within 1e-10 relative L2 per field and frame, processor_ID
  equal (both packages partition with the same C++ RCB);
* ADPM on make_adpm_case(n=3) at 4 shards in both packages
  (ROADMAP queue 3, 3.1): the first solve's operator is the reference's
  (its block-Jacobi inverse, preconditioned right-hand side and warm
  start bit for bit, the first iteration's dot partials at round-off),
  and in both its BiCGStab recurrence runs into the same near-breakdown
  (rho within 1e-9 of round-off before iteration 100);
* ADPM, PROTEAS and RIPF on their generated cases, PIHNA on a HEX8
  mesh, PIHNA with a bisection AMR pass, and a checkpoint written after
  that pass and resumed: each multi-device run
  against the port's own single-device run at the reference's
  multi-device bar (rtol 1e-8, atol 1e-8 (1 + max|field|),
  tests/test_drivers_multichip.py; the single-device drivers are held to
  the reference elsewhere), and the resumed run's last CSV row equal to
  the uninterrupted run's;
* the coupled HCC driver on make_hcc_case(n=2) at 2 shards (the moving
  mesh's transport and the solid's halo Newton) against its one-device
  run at the same bar (the solid driver's: tests/test_torch_drivers.py
  and tests/test_torch_solid_halo.py).  The drivers on a MixedMesh:
  tests/test_torch_halo_drivers_mixed.py."""

import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

import rdcfes_tpu.parallel.halo as jhalo
from rdcfes_tpu.drivers import adpm as jadpm
from rdcfes_tpu.drivers import pihna as jpihna
from rdcfes_tpu.io import vtu as jvtu

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import adpm, pihna, proteas, ripf
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.mesh import box_hex_mesh, gmsh
from rdcfes_tpu_torch.parallel import halo as phalo

from tests.test_torch_drivers import _arrays, _run, _same_frames
from tests.torch_helpers import quick_compile, reference_native_rcb, rel_l2

PAR = "parallel/n_devices = {}\n"


def _case(make, d, edits=(), extra="", **kw):
    """make(d, **kw) with the deck's `edits` (old, new) and `extra` lines."""
    make(d, **kw)
    path = os.path.join(d, "input.dat")
    deck = open(path).read()
    for old, new in edits:
        assert old in deck, old
        deck = deck.replace(old, new)
    open(path, "w").write(deck + extra)
    return d


def _csv_rows(run):
    lines = open(os.path.join(run.out, "output.csv")).read().splitlines()
    return np.array([[float(x) for x in ln.split(",")] for ln in lines
                     if ln and not ln.startswith('"')])


def _pids(run):
    vtus = sorted(f for f in os.listdir(run.out) if f.endswith(".vtu"))
    return [np.array(_arrays(os.path.join(run.out, f))["processor_ID"]
                     .split(), dtype=int) for f in vtus]


def _pair(tmp_path, make, fn, D, edits=(), extra="", **kw):
    """(D-shard run, one-device run) of the same generated case."""
    runs = []
    for name, par in (("multi", PAR.format(D)), ("one", "")):
        d = _case(make, str(tmp_path / name), edits, extra + par, **kw)
        runs.append(_run(d, lambda: fn("input.dat", device="cpu"),
                         vtu.ParaviewWriter))
    return runs


PIHNA_EDITS = (("output_step = 10", "output_step = 2"),)


def test_pihna_driver_matches_reference(tmp_path):
    """Both packages' PIHNA drivers at 8 shards on make_pihna_case(n=3)."""
    extra = PAR.format(8) + "solver/linear/tolerance = 1e-14\n"
    dirs = [_case(cases.make_pihna_case, str(tmp_path / t), PIHNA_EDITS,
                  extra, n=3, n_steps=4) for t in ("ref", "port")]
    with reference_native_rcb(tmp_path), quick_compile():
        ref = _run(dirs[0], lambda: jpihna.run("input.dat"),
                   jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: pihna.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    assert [t for t, _, _ in port.frames] == [0, 2, 4]
    for (t0, fr, _), (t1, fp, _) in zip(ref.frames, port.frames):
        assert t0 == t1 and fr.keys() == fp.keys()
        for k in fr:
            if np.linalg.norm(fr[k]) > 0:
                assert rel_l2(fp[k], fr[k]) <= 1e-10, (t0, k)
            else:
                assert np.abs(fp[k]).max() <= 1e-300, (t0, k)
    a, b = _csv_rows(port), _csv_rows(ref)
    assert a.shape == b.shape == (3, b.shape[1])
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-300)
    pr, pp = _pids(ref), _pids(port)
    assert len(pr) == len(pp) == 3
    for x, y in zip(pp, pr):
        np.testing.assert_array_equal(x, y)
    assert set(pp[0]) == set(range(8))


@pytest.mark.parametrize("driver", ["adpm", "proteas", "ripf"])
def test_drivers_match_one_device(driver, tmp_path):
    make, fn, kw, edits = {
        "adpm": (cases.make_adpm_case, adpm.run, {"n": 3, "n_steps": 4},
                 (("output_step = 20", "output_step = 2"),)),
        "proteas": (cases.make_proteas_case, proteas.run,
                    {"n": 3, "n_steps": 4}, ()),
        "ripf": (cases.make_ripf_case, ripf.run, {"n": 3, "n_steps": 4},
                 (("output_time_points = ' 10 30 60 90 120 '",
                   "output_time_points = ' 2 4 '"),)),
    }[driver]
    # ADPM on 3 shards: on 4 the first solve's recurrence, the
    # reference's, runs into a near-breakdown that the port's rounding
    # turns into rho = 0 at iteration 88 (a freeze) and the reference's
    # does not; test_adpm_four_shards_near_breakdown_in_both_packages
    # holds the 4-shard solve to the reference's
    D = 3 if driver == "adpm" else 4
    multi, one = _pair(tmp_path, make, fn, D, edits, **kw)
    assert multi.stdout.count(" ==== Step") == 4
    assert len(multi.frames) >= 2
    _same_frames(multi, one)
    if driver != "proteas":  # PROTEAS writes no CSV rows
        np.testing.assert_allclose(_csv_rows(multi), _csv_rows(one),
                                   rtol=1e-8, atol=1e-12)
    assert set(_pids(multi)[-1]) == set(range(D))


def test_pihna_hex8_matches_one_device(tmp_path):
    """PIHNA on a HEX8 mesh (box_hex_mesh(3), the generated case's
    inputs resized) on 3 shards."""
    mesh = box_hex_mesh(3, 3, 3)
    rng = np.random.default_rng(7)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 2.39e4 * rng.random(mesh.n_nodes)
    u0[:, 3] = 7200.0
    u0[:, 4] = 1e-9

    def make(d, **kw):
        cases.make_pihna_case(d, **kw)
        gmsh.write(mesh, os.path.join(d, "Brain_Model.msh"))
        np.savetxt(os.path.join(d, "Brain_Model_Initial_Nodal_Field.dat"),
                   u0)
        np.savetxt(os.path.join(d,
                                "Brain_Model_Initial_Elemental_Field.dat"),
                   np.zeros((mesh.n_elems, 2)))

    # the case's cells grow a hundredfold in 4 steps, and the growth
    # amplifies the two solves' gap: at 3e-11 it reaches 4e-6 relative
    multi, one = _pair(tmp_path, make, pihna.run, 3, PIHNA_EDITS,
                       "solver/linear/tolerance = 1e-14\n", n=2, n_steps=4)
    assert "elem_type=HEX8" in multi.stdout
    _same_frames(multi, one)
    assert set(_pids(multi)[-1]) == {0, 1, 2}


def test_pihna_amr_and_checkpoint_resume(tmp_path):
    """4 shards with one bisection AMR pass at step 2 and a checkpoint at
    step 3 (after the pass, on the refined mesh): the frames of the
    one-device run, and a resume from that checkpoint ends on the
    uninterrupted run's last CSV row."""
    extra = ("refinement_step = 2\nmesh/AMR/max_steps = 1\n"
             "mesh/AMR/max_level = 1\ncheckpoint/step = 3\n")
    edits = PIHNA_EDITS + (("refinement_step = 10000\n", ""),)
    multi, one = _pair(tmp_path, cases.make_pihna_case, pihna.run, 4, edits,
                       extra, n=3, n_steps=4)
    assert "AMR step 2: adapted to " in multi.stdout
    _same_frames(multi, one)
    # the refined mesh's elements, all four shards
    assert len(_pids(multi)[-1]) > len(_pids(multi)[0])
    assert set(_pids(multi)[-1]) == set(range(4))
    d = os.path.dirname(multi.out)
    shutil.copy(os.path.join(multi.out, "checkpoint.npz"),
                os.path.join(d, "ck.npz"))
    shutil.copy(os.path.join(multi.out, "checkpoint_mesh.msh"),
                os.path.join(d, "checkpoint_mesh.msh"))
    full = open(os.path.join(multi.out, "output.csv")).read().splitlines()
    shutil.rmtree(multi.out)
    with open(os.path.join(d, "input.dat"), "a") as f:
        f.write("checkpoint/resume = ck.npz\n")
    resumed = _run(d, lambda: pihna.run("input.dat", device="cpu"),
                   vtu.ParaviewWriter)
    assert "resumed on AMR mesh" in resumed.stdout
    last = open(os.path.join(resumed.out, "output.csv")).read().splitlines()
    assert last[-1] == full[-1]


def test_unported_multi_device_paths_raise(tmp_path):
    """The coupled HCC driver on several devices, which raised until it
    was ported, runs: make_hcc_case(n=2) at 2 shards gives the one-device
    run's frames (the RDC state through the moving halo system, the
    positions through the halo Newton)."""
    from rdcfes_tpu_torch.drivers import coupled_hcc

    multi, one = _pair(tmp_path, cases.make_hcc_case, coupled_hcc.run, 2,
                       n=2, n_steps=2, n_loading=1)
    assert multi.stdout.count(" ==== Step") == 2
    assert "   Newton: " in multi.stdout
    assert len(one.frames) == 3
    _same_frames(multi, one)


# ----------------------------------------------------------------------
# fault 3.1: ADPM on 4 shards, both packages
# ----------------------------------------------------------------------
def _solves(events):
    """A shard's recorded events split into solves: the leading non-dot
    events (dinv, b, x0) and the dot partials after them, in order."""
    out = []
    for tag, v in events:
        if tag != "dot":
            if not out or out[-1]["dots"]:
                out.append({"dots": []})
            out[-1][tag] = v
        else:
            out[-1]["dots"].append(float(v))
    return out


def _rho_ratios(solves):
    """|rho1| over the sum of its shards' |partials| at each iteration of
    the first solve (dots: b.b, r.r, then rho1, rtv, tt, t.st, r.r per
    iteration)."""
    assert len({len(sv[0]["dots"]) for sv in solves}) == 1
    rho = np.array([sv[0]["dots"] for sv in solves])[:, 2::5]
    total = rho[0].copy()
    for part in rho[1:]:
        total = total + part  # in shard order, as both packages sum
    return np.abs(total) / np.abs(rho).sum(axis=0)


def test_adpm_four_shards_near_breakdown_in_both_packages(tmp_path,
                                                          monkeypatch):
    """Fault 3.1 settled: on make_adpm_case(n=3) at 4 shards the port's
    first halo solve is the reference's (two steps here: the first solve
    is the 4-step case's).  Its block-Jacobi
    inverse, preconditioned right-hand side and warm start equal the
    reference's 4-device values bit for bit (the measured gap: 0), and
    the first iteration's seven dot partials on every shard lie within
    1e-13 relative (2.6e-14 measured).  The recurrence then parts at
    round-off and, in both packages, rho = (rhat, r) cancels: it falls
    below 1e-9 of its partials' sum of magnitudes before iteration 100
    (the port's at 29, exactly 0 at 88, where the breakdown freeze
    stops it; the reference's at 43, 3e-11 at 88, and it converges in
    333).  The recurrence and its freeze are the reference's
    (rdcfes_tpu/parallel/halo.py:1459-1498); the two runs part by the
    luck of their rounding, not by their operators."""
    D = 4
    edits = (("output_step = 20", "output_step = 2"),)
    dirs = [_case(cases.make_adpm_case, str(tmp_path / t), edits,
                  PAR.format(D), n=3, n_steps=2) for t in ("ref", "port")]
    ref = {s: [] for s in range(D)}

    def rec(tag):
        def put(i, v):
            ref[int(i)].append((tag, np.asarray(v).copy()))
        return put

    j_bicg, j_inv = jhalo._bicgstab_dist, jhalo.small_block_inverse

    def bicg(matvec, b, x0, msk, pdot, rtol, maxiter):
        i = lax.axis_index("d")
        jax.debug.callback(rec("b"), i, b)
        jax.debug.callback(rec("x0"), i, x0)

        def pdot_rec(a, c):
            v = jnp.vdot(a, c)
            jax.debug.callback(rec("dot"), i, v)
            return lax.psum(v, "d")
        return j_bicg(matvec, b, x0, msk, pdot_rec, rtol, maxiter)

    def inv(diag, pivot=False):
        out = j_inv(diag, pivot=pivot)
        jax.debug.callback(rec("dinv"), lax.axis_index("d"), out)
        return out

    monkeypatch.setattr(jhalo, "_bicgstab_dist", bicg)
    monkeypatch.setattr(jhalo, "small_block_inverse", inv)
    with reference_native_rcb(tmp_path), quick_compile():
        _run(dirs[0], lambda: jadpm.run("input.dat"), jvtu.ParaviewWriter)

    port = {s: [] for s in range(D)}
    p_bicg, p_inv = phalo._bicgstab_dist, phalo.small_block_inverse
    n_inv = [0]

    class Recorded:
        def __init__(self, group):
            self.group, self.devices = group, group.devices

        def psum(self, vals):
            for s, v in enumerate(vals):
                port[s].append(("dot", v.item()))
            return self.group.psum(vals)

    def pbicg(matvec, b, x0, msk, group, rtol, maxiter):
        for s in range(D):
            port[s] += [("b", b[s].numpy().copy()),
                        ("x0", x0[s].numpy().copy())]
        return p_bicg(matvec, b, x0, msk, Recorded(group), rtol, maxiter)

    def pinv(dg, pivot=False):
        out = p_inv(dg, pivot=pivot)
        port[n_inv[0] % D].append(("dinv", out.numpy().copy()))
        n_inv[0] += 1
        return out

    monkeypatch.setattr(phalo, "_bicgstab_dist", pbicg)
    monkeypatch.setattr(phalo, "small_block_inverse", pinv)
    _run(dirs[1], lambda: adpm.run("input.dat", device="cpu"),
         vtu.ParaviewWriter)

    rs = [_solves(ref[s]) for s in range(D)]
    ps = [_solves(port[s]) for s in range(D)]
    for r, p in zip(rs, ps):
        assert len(r) == len(p) == 2  # one solve a step
        for k in ("dinv", "b", "x0"):
            np.testing.assert_allclose(
                p[0][k], r[0][k], rtol=0,
                atol=1e-14 * np.abs(r[0][k]).max(), err_msg=k)
        np.testing.assert_allclose(p[0]["dots"][:7], r[0]["dots"][:7],
                                   rtol=1e-13, atol=0)
    for solves in (rs, ps):
        ratio = _rho_ratios(solves)
        assert ratio[0] == 1.0
        assert (ratio[:100] < 1e-9).any()
