"""The port's RDC drivers on a MixedMesh with `parallel/n_devices` > 1
(the halo system of rdcfes_tpu_torch/parallel/halo.py on build_mixed_plan,
every shard on the CPU here):

* the PIHNA driver on make_pihna_case(n=3, mixed=True) at 4 shards
  against the reference's driver at 4 virtual devices (tests/
  conftest.py), both at solver/linear/tolerance 1e-14: every VTU field
  within 1e-8 relative L2 a frame, the CSV rows within 1e-8,
  processor_ID equal (both packages partition with the same C++ RCB);
* ADPM, PROTEAS and RIPF on their mixed cases, and PIHNA with a 1:8 AMR
  pass of the TET4 block (hanging nodes on the plan) and a checkpoint
  written after it and resumed, each at 4 shards against the port's
  one-device run at the reference's multi-device bar (rtol 1e-8, atol
  1e-8 (1 + max|field|)), and the resumed run's last CSV row equal to
  the uninterrupted run's."""

import os
import shutil

import numpy as np
import pytest

from rdcfes_tpu.drivers import pihna as jpihna
from rdcfes_tpu.io import vtu as jvtu

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import adpm, pihna, proteas, ripf
from rdcfes_tpu_torch.io import vtu

from tests.test_torch_drivers import _run, _same_frames
from tests.test_torch_drivers_multichip import (PAR, PIHNA_EDITS, _case,
                                                _csv_rows, _pair, _pids)
from tests.torch_helpers import quick_compile, reference_native_rcb, rel_l2

MIXED_TOL = "solver/linear/tolerance = 1e-14\n"


def test_pihna_mixed_driver_matches_reference(tmp_path):
    """Both packages' PIHNA drivers on make_pihna_case(n=3, mixed=True)
    at 4 shards (the reference's mixed halo system, build_mixed_plan and
    its dense shard step; the port's qp path over the same plan), at
    solver/linear/tolerance 1e-14: every VTU field within 1e-8 relative
    L2 a frame, the CSV rows within 1e-8, processor_ID equal."""
    dirs = [_case(cases.make_pihna_case, str(tmp_path / t), PIHNA_EDITS,
                  PAR.format(4) + MIXED_TOL, n=3, n_steps=2, mixed=True)
            for t in ("ref", "port")]
    with reference_native_rcb(tmp_path), quick_compile():
        ref = _run(dirs[0], lambda: jpihna.run("input.dat"),
                   jvtu.ParaviewWriter)
    port = _run(dirs[1], lambda: pihna.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    assert "elem_type=MIXED" in port.stdout
    assert [t for t, _, _ in port.frames] == [t for t, _, _ in ref.frames]
    for (t0, fr, _), (_, fp, _) in zip(ref.frames, port.frames):
        assert fr.keys() == fp.keys()
        for k in fr:
            if np.linalg.norm(fr[k]) > 0:
                assert rel_l2(fp[k], fr[k]) <= 1e-8, (t0, k)
            else:
                assert np.abs(fp[k]).max() <= 1e-300, (t0, k)
    np.testing.assert_allclose(_csv_rows(port), _csv_rows(ref), rtol=1e-8,
                               atol=1e-300)
    pr, pp = _pids(ref), _pids(port)
    for x, y in zip(pp, pr):
        np.testing.assert_array_equal(x, y)
    assert set(pp[-1]) == set(range(4))


@pytest.mark.parametrize("driver", ["adpm", "proteas", "ripf"])
def test_mixed_drivers_match_one_device(driver, tmp_path):
    """ADPM (at the taxis amplitude 50, the watch-list's), PROTEAS and
    RIPF on their mixed cases at 4 shards against one device, at
    solver/linear/tolerance 1e-14: the one-device mixed system refines in
    mixed precision well past 3e-11, while the halo solve stops there,
    and the stop rule's gap in the small species (RIPF's cc, ADPM's Tau)
    crosses the CSV's thresholds (the reference's own
    test_ripf_multichip_mixed_mesh fails on it: ROADMAP item 0)."""
    make, fn, edits = {
        "adpm": (cases.make_adpm_case, adpm.run,
                 (("output_step = 20", "output_step = 1"),
                  ("0.999999e+3", "50.0"))),
        "proteas": (cases.make_proteas_case, proteas.run, ()),
        "ripf": (cases.make_ripf_case, ripf.run,
                 (("output_time_points = ' 10 30 60 90 120 '",
                   "output_time_points = ' 1 2 '"),)),
    }[driver]
    multi, one = _pair(tmp_path, make, fn, 4, edits, MIXED_TOL, n=3,
                       n_steps=2, mixed=True)
    assert multi.stdout.count(" ==== Step") == 2
    assert "elem_type=MIXED" in multi.stdout and len(multi.frames) >= 2
    _same_frames(multi, one)
    if driver != "proteas":  # PROTEAS writes no CSV rows
        np.testing.assert_allclose(_csv_rows(multi), _csv_rows(one),
                                   rtol=1e-8, atol=1e-12)
    assert set(_pids(multi)[-1]) == set(range(4))


def test_pihna_mixed_amr_and_checkpoint_resume(tmp_path):
    """make_pihna_case(n=3, mixed=True) on 4 shards with one 1:8 AMR pass
    of its TET4 block at step 2 (hanging nodes on the plan) and a
    checkpoint at step 3: the frames of the one-device run, and a resume
    from that checkpoint, on 4 shards, ends on the uninterrupted run's
    last CSV row."""
    extra = ("refinement_step = 2\nmesh/AMR/max_steps = 1\n"
             "mesh/AMR/max_level = 1\ncheckpoint/step = 3\n" + MIXED_TOL)
    edits = PIHNA_EDITS + (("refinement_step = 10000\n", ""),)
    multi, one = _pair(tmp_path, cases.make_pihna_case, pihna.run, 4, edits,
                       extra, n=3, n_steps=4, mixed=True)
    assert "hanging nodes" in multi.stdout
    _same_frames(multi, one)
    assert len(_pids(multi)[-1]) > len(_pids(multi)[0])
    assert set(_pids(multi)[-1]) == set(range(4))
    d = os.path.dirname(multi.out)
    for name in ("checkpoint.npz", "checkpoint_mesh.msh"):
        shutil.copy(os.path.join(multi.out, name),
                    os.path.join(d, name.replace("checkpoint.", "ck.")))
    full = open(os.path.join(multi.out, "output.csv")).read().splitlines()
    shutil.rmtree(multi.out)
    with open(os.path.join(d, "input.dat"), "a") as f:
        f.write("checkpoint/resume = ck.npz\n")
    resumed = _run(d, lambda: pihna.run("input.dat", device="cpu"),
                   vtu.ParaviewWriter)
    assert "resumed on AMR mesh" in resumed.stdout
    last = open(os.path.join(resumed.out, "output.csv")).read().splitlines()
    assert last[-1] == full[-1]
