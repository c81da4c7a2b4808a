"""The port's coupled HCC slice against rdcfes_tpu: the model, the moving
mesh of TransientRDCSystem, the case and the driver.

* hcc_blocks, with a live deck and the all-zero one, with and without a
  grad_sigma field: every block within 1e-13 of the largest reference
  value, the same structural zeros;
* the moving TET4 step: `step(coords=)` against the reference's
  `step(coords=)` (its assembled _step_moving) on box_tet_mesh(3,3,3)
  under a seeded smooth non-affine displacement at rtol 1e-14 in both,
  then `run_steps(coords=)` against the reference's, one step at each of
  three other displacements at the drivers' rtol 3e-11, with equal inner
  iteration counts; within 1e-10 relative L2 per step;
* one moving HEX8 step against the direct solve of the reference's
  fixed system on `mesh.with_coords(moved)`, whose geometry is exactly
  the one the moving step must rebuild
  (tests/torch_helpers.reference_direct_step);
* the block-Jacobi inverse is rebuilt for every new geometry, whatever
  precond_refresh says;
* the driver on make_hcc_case(n=3, n_steps=4, n_loading=2) with
  `solver/linear/tolerance = 1e-14` and `checkpoint/step = 2`, one
  reference run: inputs, `output.msh` and the PVD byte-equal; positions
  and displacements within 1e-10 of the displacement scale; l, c and n
  within 1e-10 of each species' largest value; p, VM and the current
  fibres within 1e-8 of each field's largest value; banners, Newton
  counts and unused-key warnings equal; one-step segments (a checkpoint
  every step) end where the two-step ones end; the step-2 checkpoints of
  both packages resume in the port to the uninterrupted run;
* make_hcc_case's files byte-equal to the reference's (the Makefile
  launches rdcfes_tpu_torch.cli); the driver at `parallel/n_devices = 3`
  ends where the one-device run ends (the same bars); and what the
  reference refuses raises before the first step.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rdcfes_tpu.utils as jutils
from rdcfes_tpu import cases as jcases
from rdcfes_tpu.drivers import coupled_hcc as jhcc
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import tet4_to_tet10 as jax_tet4_to_tet10
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.models import hcc as jmodel
from rdcfes_tpu.systems import TransientRDCSystem as JaxSystem

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import coupled_hcc
from rdcfes_tpu_torch.io import vtu
from rdcfes_tpu_torch.models import hcc
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.systems import transient as transient_mod
from rdcfes_tpu_torch.utils.convert import mesh_from_reference

from tests.test_torch_drivers import (_check_files, _run, _summary_lines,
                                      _warnings)
from tests.test_torch_proteas_ripf import _check_blocks
from tests.torch_helpers import quick_compile, reference_direct_step, rel_l2

RTOL = 1e-14
DRIVER_RTOL = 3e-11  # drivers/common.make_rdc_system's default
TEST_DECK = "solver/linear/tolerance = 1e-14\ncheckpoint/step = 2\n"
SPECIES = ("l", "c", "n")


@pytest.fixture(scope="module", autouse=True)
def _cheap_reference_compiles():
    with quick_compile():
        yield


def _params(kind="live"):
    p = jmodel.default_params()
    p["dt"] = 0.05
    if kind == "live":
        p.update(cells_min_capacity=0.05, cells_max_capacity=1.0,
                 cells_max_capacity_exponent=3.0, produce_l=0.2,
                 diffuse_c=0.3, mechano_c=0.4, produce_c=0.5,
                 necrosis_l=0.05, necrosis_c=0.1)
    return {k: float(v) for k, v in p.items()}


def _moved(coords, seed, amp=0.04):
    """A seeded smooth, non-affine displacement of the unit box."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(1.0, 2.5, (3, 3))
    phase = rng.uniform(0.0, 2 * np.pi, 3)
    return coords + amp * np.sin(np.pi * coords @ k.T + phase)


def _state(coords):
    r2 = ((coords - 0.5) ** 2).sum(axis=1)
    rng = np.random.default_rng(9)
    return np.stack([0.6 - 0.4 * np.exp(-r2 / 0.1),
                     0.4 * np.exp(-r2 / 0.1) + 0.02 * rng.random(len(r2)),
                     0.05 * np.exp(-r2 / 0.05)], axis=1)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["live", "zero"])
@pytest.mark.parametrize("with_sigma", [False, True])
def test_hcc_blocks_match_reference(kind, with_sigma):
    p = _params(kind)
    rng = np.random.default_rng(31)
    Q, E = 4, 50
    # the total straddles Kappa_k (the crowding's clamped branches) and c
    # straddles Lambda_k (both sides of the gate)
    u = rng.uniform(0.0, 0.5, (3, Q, E))
    u[:, :, :5] *= 3.0
    u[1, :, 5:12] = 0.01
    grad = rng.standard_normal((3, Q, 3, E))
    sigma = rng.standard_normal((Q, 3, E))
    jf = {"grad_sigma": jnp.asarray(sigma)} if with_sigma else {}
    pf = {"grad_sigma": torch.as_tensor(sigma)} if with_sigma else {}
    ref = jmodel.hcc_blocks(jnp.asarray(u), jnp.asarray(grad), jf, p)
    out = hcc.hcc_blocks(torch.as_tensor(u), torch.as_tensor(grad), pf, p)
    live = _check_blocks(out, ref)
    # A 3; C 6 whatever the deck (the spurious `one` terms), C20 and C21
    # with necrosis; B, D10, D11 and E11 with a live diffusivity
    assert live == {"live": 3 + 8 + 4, "zero": 3 + 6}[kind]
    assert hcc.HCC_VARS == jmodel.HCC_VARS
    assert hcc.default_params() == jmodel.default_params()


# ----------------------------------------------------------------------
# the moving mesh
# ----------------------------------------------------------------------
def _tet_pair(rtol=RTOL):
    jmesh = jax_box_tet_mesh(3, 3, 3)
    jsys = JaxSystem(jmesh, 3, jmodel.hcc_physics,
                     physics_blocks=jmodel.hcc_blocks, moving_mesh=True,
                     rtol=rtol)
    port = TransientRDCSystem(mesh_from_reference(jmesh), 3, hcc.hcc_blocks,
                              moving_mesh=True, rtol=rtol, device="cpu")
    return jmesh, jsys, port


def _check_state(st, jst, bar=1e-10):
    for key in ("u", "u_raw"):
        err = rel_l2(st[key].numpy(), np.asarray(jst[key]))
        assert err <= bar, (key, err)


def test_moving_tet4_steps_match_reference():
    """step(coords=) against the reference's assembled moving step, then
    run_steps(coords=) against its qp scan at three other geometries,
    each from the reference's state, at the drivers' rtol: there the
    inner iteration count is the algorithm's, not round-off's, and the
    port's equals the reference's at every step."""
    jmesh, jsys, port = _tet_pair()
    p = _params()
    u0 = _state(jmesh.coords)
    moved = _moved(jmesh.coords, 0)
    jst, _, jres = jsys.step(jsys.initial_state(jnp.asarray(u0)), params=p,
                             coords=jnp.asarray(moved))
    st, its, res = port.step(port.initial_state(u0), params=p, coords=moved)
    _check_state(st, jst)
    assert float(res) <= RTOL and int(its) > 0
    # a stale geometry would show here: the rest mesh's step differs
    fixed = TransientRDCSystem(port.mesh, 3, hcc.hcc_blocks, rtol=RTOL,
                               device="cpu")
    rest, _, _ = fixed.step(fixed.initial_state(u0), params=p)
    assert rel_l2(rest["u"].numpy(), np.asarray(jst["u"])) > 1e-6
    _, jsys, port = _tet_pair(DRIVER_RTOL)
    for seed in (1, 2, 3):
        moved = _moved(jmesh.coords, seed)
        st, its, ress = port.run_steps(
            port.scatter_state({k: np.asarray(v) for k, v in jst.items()}),
            1, params=p, coords=torch.as_tensor(moved))
        jst, jits, _ = jsys.run_steps(jst, 1, params=p,
                                      coords=jnp.asarray(moved))
        assert float(ress[0]) <= DRIVER_RTOL
        _check_state(st, jst)
        assert its.tolist() == np.asarray(jits).tolist()


def test_moving_hex8_step_matches_direct_solve():
    """One moving HEX8 step (K8, K6 and block_rhs on the rebuilt
    geometry) against the direct solve of the reference's fixed system
    on the moved mesh."""
    jmesh = jax_box_hex_mesh(2, 2, 2)
    moved = _moved(jmesh.coords, 4)
    p = _params()
    u0 = _state(jmesh.coords)
    jsys = JaxSystem(jmesh.with_coords(moved), 3, jmodel.hcc_physics,
                     physics_blocks=jmodel.hcc_blocks)
    ref_raw = reference_direct_step(jsys, jmodel.hcc_blocks, u0, {}, p)
    port = TransientRDCSystem(mesh_from_reference(jmesh), 3, hcc.hcc_blocks,
                              moving_mesh=True, rtol=RTOL, device="cpu")
    st, _, res = port.step(port.initial_state(u0), params=p, coords=moved)
    assert float(res) <= RTOL
    assert rel_l2(st["u_raw"].numpy(), ref_raw) <= 1e-10
    st, _, _ = port.run_steps(port.initial_state(u0), 1, params=p,
                              coords=moved)
    assert rel_l2(st["u_raw"].numpy(), ref_raw) <= 1e-10


def test_inverse_rebuilt_for_each_geometry(monkeypatch):
    """precond_refresh > 1 reuses the inverse on a fixed mesh only: a new
    coords builds a fresh one on every step and every run_steps call."""
    jmesh, _, _ = _tet_pair()
    mesh = mesh_from_reference(jmesh)
    p = _params()
    u0 = _state(jmesh.coords)
    built = []
    inverse = transient_mod.small_block_inverse
    monkeypatch.setattr(transient_mod, "small_block_inverse",
                        lambda *a, **kw: built.append(1) or inverse(*a,
                                                                    **kw))
    s = TransientRDCSystem(mesh, 3, hcc.hcc_blocks, moving_mesh=True,
                           precond_refresh=5, rtol=RTOL, device="cpu")
    st = s.initial_state(u0)
    st, _, _ = s.run_steps(st, 2, params=p, coords=_moved(jmesh.coords, 1))
    assert len(built) == 1
    b = _moved(jmesh.coords, 2)
    out_b, _, _ = s.step(st, params=p, coords=b)
    out_c, _, _ = s.step(st, params=p, coords=_moved(jmesh.coords, 3))
    assert len(built) == 3 and s._dinv_cache is None
    fresh = TransientRDCSystem(mesh, 3, hcc.hcc_blocks, moving_mesh=True,
                               precond_refresh=5, rtol=RTOL, device="cpu")
    again, _, _ = fresh.step(st, params=p, coords=b)
    assert torch.equal(again["u"], out_b["u"])
    assert not torch.equal(out_c["u"], out_b["u"])


# ----------------------------------------------------------------------
# the case and the driver
# ----------------------------------------------------------------------
def test_hcc_case_matches_reference(tmp_path):
    a, b = tmp_path / "port", tmp_path / "ref"
    cases.make_hcc_case(str(a), n=3, n_steps=6, n_loading=3)
    jcases.make_hcc_case(str(b), n=3, n_steps=6, n_loading=3)
    names = sorted(p.name for p in b.iterdir())
    assert sorted(p.name for p in a.iterdir()) == names
    for n in names:
        x, y = (a / n).read_text(), (b / n).read_text()
        if n == "Makefile":
            assert "python3 -m rdcfes_tpu_torch.cli -c hcc" in x
            x = x.replace("rdcfes_tpu_torch.cli", "rdcfes_tpu.cli")
        assert x == y, n
    # mixed=True: the box in HEX8 + PYRAMID5 + TET4 blocks, each with the
    # three subdomains (its bytes: tests/test_torch_hcc_ext.py)
    cases.make_hcc_case(str(tmp_path / "m"), n=3, mixed=True)
    mixed = jgmsh.read(str(tmp_path / "m" / "HCC_Model.msh"))
    assert [b.elem_type for b in mixed.blocks] == ["HEX8", "PYRAMID5",
                                                   "TET4"]
    assert set(mixed.subdomain_id) == {3000, 3001, 3002}


def _case(d, extra=TEST_DECK):
    cases.make_hcc_case(d, n=3, n_steps=4, n_loading=2)
    with open(os.path.join(d, "input.dat"), "a") as f:
        f.write(extra)
    return d


@pytest.fixture(scope="module")
def hcc_runs(tmp_path_factory):
    """(reference run, port run); each package's checkpoint of each step
    is kept as checkpoint-<step>.npz."""
    dirs = [_case(str(tmp_path_factory.mktemp(t)))
            for t in ("hcc_ref", "hcc_port")]

    def keeping(save):
        def keep_each(path, state, step, *a, **kw):
            save(path, state, step, *a, **kw)
            shutil.copy(path, path.replace(".npz", f"-{step}.npz"))
        return keep_each

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "save_checkpoint",
                   keeping(jutils.save_checkpoint))
        mp.setattr(coupled_hcc, "save_checkpoint",
                   keeping(coupled_hcc.save_checkpoint))
        ref = _run(dirs[0], lambda: jhcc.run("input.dat"),
                   jvtu.ParaviewWriter)
        port = _run(dirs[1], lambda: coupled_hcc.run("input.dat",
                                                     device="cpu"),
                    vtu.ParaviewWriter)
    return ref, port


def _u_scale(run):
    return np.abs(np.stack([f[1][n] for f in run.frames
                            for n in ("u_x", "u_y", "u_z")])).max()


def _check_frames(ref_frames, port_frames, u_scale):
    assert [f[0] for f in ref_frames] == [f[0] for f in port_frames]
    for (t, fa, xa), (_, fb, xb) in zip(ref_frames, port_frames):
        assert np.abs(xb - xa).max() <= 1e-10 * u_scale, t
        for n in ("x", "y", "z", "u_x", "u_y", "u_z"):
            assert np.abs(fb[n] - fa[n]).max() <= 1e-10 * u_scale, (t, n)
        for n in SPECIES:
            assert np.isfinite(fb[n]).all()
            tol = 1e-10 * np.abs(fa[n]).max()
            assert np.abs(fb[n] - fa[n]).max() <= tol, (t, n)
        for n in ("p", "VM", "fibre_current_x", "fibre_current_y",
                  "fibre_current_z"):
            tol = 1e-8 * np.abs(fa[n]).max()
            assert np.abs(fb[n] - fa[n]).max() <= tol, (t, n)
        for n in ("undeformed_x", "fibre_reference_x"):
            assert np.array_equal(fa[n], fb[n])


def test_hcc_driver_matches_reference(hcc_runs):
    ref, port = hcc_runs
    names = _check_files(ref, port, [
        "output.msh", "input.dat", "HCC_Initial_Nodal_Field.dat",
        "out.pvd"])
    assert [f"out-{t}.vtu" in names for t in (0, 2, 4)] == [True] * 3
    u_scale = _u_scale(ref)
    assert u_scale > 0  # the tumour core grew: the mesh moved
    _check_frames(ref.frames, port.frames, u_scale)
    assert not np.array_equal(port.frames[-1][2],
                              np.stack([port.frames[0][1][n] for n in (
                                  "undeformed_x", "undeformed_y",
                                  "undeformed_z")], axis=1))
    assert _summary_lines(port.stdout) == _summary_lines(ref.stdout)
    assert port.stdout.count(" ==== Step") == 4
    newton = lambda s: re.findall(r"Newton: (\d+) iterations", s)
    assert newton(port.stdout) == newton(ref.stdout) and len(
        newton(ref.stdout)) == 2
    assert _warnings(port.stderr) == _warnings(ref.stderr)
    assert " Performance log: coupled_hcc" in port.stdout


def test_hcc_one_step_segments_match_the_run(hcc_runs, tmp_path,
                                             monkeypatch):
    """A checkpoint every step makes every segment one step long; each
    goes through run_steps(coords=) and the run ends where the two-step
    segments of the port's run end (the same bars)."""
    _, port = hcc_runs
    segs = []
    run_steps = TransientRDCSystem.run_steps
    monkeypatch.setattr(
        TransientRDCSystem, "run_steps",
        lambda self, st, n, *a, **kw: segs.append(n) or run_steps(
            self, st, n, *a, **kw))
    d = _case(str(tmp_path), TEST_DECK.replace("step = 2", "step = 1"))
    one = _run(d, lambda: coupled_hcc.run("input.dat", device="cpu"),
               vtu.ParaviewWriter)
    assert segs == [1, 1, 1, 1]
    assert _summary_lines(one.stdout) == _summary_lines(port.stdout)
    _check_frames(port.frames, one.frames, _u_scale(port))


@pytest.mark.parametrize("package", ["port", "reference"])
def test_hcc_checkpoint_resumes_in_the_port(hcc_runs, package, tmp_path):
    """Either package's step-2 checkpoint, resumed in the port's driver,
    ends at the port's uninterrupted run (the same bars)."""
    ref, port = hcc_runs
    ck = os.path.join((port if package == "port" else ref).out,
                      "checkpoint-2.npz")
    d = _case(str(tmp_path), TEST_DECK + f"checkpoint/resume = '{ck}'\n")
    resumed = _run(d, lambda: coupled_hcc.run("input.dat", device="cpu"),
                   vtu.ParaviewWriter)
    assert f"resumed from {ck} at step 2" in resumed.stdout
    assert resumed.stdout.count(" ==== Step") == 2
    _check_frames(port.frames[-1:], resumed.frames, _u_scale(port))


def test_unported_hcc_paths_raise(hcc_runs, tmp_path, monkeypatch,
                                  capsys):
    """Several devices, which raised until they were ported, run: the
    case on 3 shards (the moving halo transport and the halo Newton) ends
    where the port's one-device run ends (the same bars); a step count
    that the loading steps do not divide raises ValueError; and
    remeshing a TET10 mesh reaches the uniform refinement, which raises
    ValueError there, as the reference's does.  Remeshing, its
    checkpoint and a MIXED mesh run (tests/test_torch_hcc_ext.py)."""
    _, port = hcc_runs
    multi = _run(_case(str(tmp_path / "multi"),
                       TEST_DECK + "parallel/n_devices = 3\n"),
                 lambda: coupled_hcc.run("input.dat", device="cpu"),
                 vtu.ParaviewWriter)
    assert _summary_lines(multi.stdout) == _summary_lines(port.stdout)
    _check_frames(port.frames, multi.frames, _u_scale(port))
    monkeypatch.chdir(tmp_path)
    run = lambda: coupled_hcc.run("input.dat", device="cpu")
    _case(str(tmp_path), "")
    deck = (tmp_path / "input.dat").read_text()
    (tmp_path / "input.dat").write_text(
        deck.replace("number_of_loading_steps = 2",
                     "number_of_loading_steps = 3"))
    with pytest.raises(ValueError, match="multiple"):
        run()
    assert " ==== Step" not in capsys.readouterr().out
    # the case on its mesh upgraded to TET10, the IC sampled at every node
    _case(str(tmp_path), "remeshing_step = 2\n")
    m10 = jax_tet4_to_tet10(jgmsh.read(str(tmp_path / "HCC_Model.msh")))
    jgmsh.write(m10, str(tmp_path / "HCC_Model.msh"))
    r2 = ((m10.coords - 5.0) ** 2).sum(axis=1)
    np.savetxt(str(tmp_path / "HCC_Initial_Nodal_Field.dat"), np.stack(
        [0.6 - 0.4 * np.exp(-r2 / 4.0), 0.4 * np.exp(-r2 / 4.0),
         0.05 * np.exp(-r2 / 2.0)], axis=1))
    with pytest.raises(ValueError, match="TET10"):
        run()
    out = capsys.readouterr().out
    assert " ==== Step    2 out of    4" in out and "remeshing step" not in out


def test_shipped_hcc_schedule_diverges_in_both_packages(tmp_path,
                                                        monkeypatch):
    """The HCC case on its shipped schedule's ratio (a load step every
    10 RDC steps) and rtol 3e-11, at n = 3, for 40 steps through both
    packages' drivers: the RDC state runs away in both (the largest
    species value, equal in both, past 1e8 by step 30), and both take the
    same per-step inner iterations through step 32, one apart at most at
    steps 33-35 (l past 1e8, each solve stopping near rtol), reach the
    first residual that is not a number at the same step, 36, and take 0
    iterations from there.  The divergence is the model's, not the
    port's."""
    import rdcfes_tpu.systems.transient as jtransient

    record = {"ref": ([], [], []), "port": ([], [], [])}

    def recording(cls, key):
        orig = cls.run_steps

        def run_steps(self, st, n, *a, **kw):
            out = orig(self, st, n, *a, **kw)
            record[key][0].extend(np.asarray(out[1]).tolist())
            record[key][1].extend(np.asarray(out[2]).tolist())
            record[key][2].append(float(np.abs(np.asarray(out[0]["u"])).max()))
            return out
        monkeypatch.setattr(cls, "run_steps", run_steps)

    recording(jtransient.TransientRDCSystem, "ref")
    recording(TransientRDCSystem, "port")
    for key, make, run in (
            ("ref", jcases.make_hcc_case, lambda: jhcc.run("input.dat")),
            ("port", cases.make_hcc_case,
             lambda: coupled_hcc.run("input.dat", device="cpu"))):
        d = str(tmp_path / key)
        make(d, n=3, n_steps=40, n_loading=4)
        _run(d, run, vtu.ParaviewWriter if key == "port"
             else jvtu.ParaviewWriter)
    (its_r, res_r, big_r), (its_p, res_p, big_p) = (record["ref"],
                                                    record["port"])
    assert len(its_r) == len(its_p) == 40
    # the largest species value after steps 10, 20, 30: equal, and past
    # 1e8 by step 30
    np.testing.assert_allclose(big_p[:3], big_r[:3], rtol=1e-6)
    assert big_r[0] < big_r[1] < big_r[2] and big_r[2] > 1e8
    first_nan = lambda res: next(i + 1 for i, r in enumerate(res)
                                 if not np.isfinite(r))
    assert first_nan(res_r) == first_nan(res_p) == 36
    assert its_p[:32] == its_r[:32]
    assert all(abs(a - b) <= 1 for a, b in zip(its_p[32:35], its_r[32:35]))
    assert its_p[35:] == its_r[35:] == [0] * 5
    assert all(r <= DRIVER_RTOL for r in res_p[:35])
