"""The port's solid driver with remeshing against the reference's solid
driver, on the meshes where a reference driver run is cheap: TET4
(bisection) and HEX8 (the uniform 1:8), at the sizes and the deck of
tests/test_torch_solid_ext.py (two load steps, remeshing after the
first, tight Newton tolerances).  Every frame (0, 1 and 2, the last on
the refined mesh): positions (the Points too) and displacements within
1e-8 of the displacement scale, p and VM within 1e-8 of each field's
largest magnitude, the undeformed coordinates equal, the Newton
iteration counts and the remeshing line equal.

The MIXED and TET10 drivers are held to the reference's AMR pieces in
tests/test_torch_solid_ext.py: a reference driver run costs 24-27 s
there, against 11-13 s here (serial, on a CPU)."""

import os
import re

import numpy as np
import pytest

from rdcfes_tpu.drivers import solid as jsolid_driver
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import gmsh as jgmsh

from rdcfes_tpu_torch.drivers import solid as solid_driver
from rdcfes_tpu_torch.io import vtu

from tests.test_torch_drivers import _run
from tests.test_torch_solid_ext import DRIVER_DECK, DRIVER_MESHES
from tests.torch_helpers import quick_compile


def _case(d, jm):
    os.makedirs(d)
    jgmsh.write(jm, os.path.join(d, "input.msh"))
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(DRIVER_DECK)
    return d


@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_solid_driver_remeshing_matches_reference_driver(kind, tmp_path):
    jm = DRIVER_MESHES[kind]()
    ref_dir, port_dir = (_case(str(tmp_path / n), jm) for n in ("ref",
                                                                "port"))
    with quick_compile():
        ref = _run(ref_dir, lambda: jsolid_driver.run("input.dat"),
                   jvtu.ParaviewWriter)
    port = _run(port_dir, lambda: solid_driver.run("input.dat", device="cpu"),
                vtu.ParaviewWriter)
    remeshed = lambda s: re.findall(r"remeshing step 1: adapted to (\d+)", s)
    assert remeshed(port.stdout) == remeshed(ref.stdout)
    assert int(remeshed(ref.stdout)[0]) > jm.n_elems
    newton = lambda s: re.findall(r"Newton: (\d+) iterations", s)
    assert newton(port.stdout) == newton(ref.stdout)
    assert len(newton(ref.stdout)) == 2
    assert [f[0] for f in ref.frames] == [f[0] for f in port.frames] == [
        0, 1, 2]
    u_scale = max(np.abs(f[1][n]).max() for f in ref.frames
                  for n in ("u_x", "u_y", "u_z"))
    assert u_scale > 0.05  # the top face moved
    for (t, fa, xa), (_, fb, xb) in zip(ref.frames, port.frames):
        assert xa.shape == xb.shape, t
        assert np.abs(xb - xa).max() <= 1e-8 * u_scale, t
        for n in ("x", "y", "z", "u_x", "u_y", "u_z"):
            assert np.abs(fb[n] - fa[n]).max() <= 1e-8 * u_scale, (t, n)
        for n in ("p", "VM"):
            tol = 1e-8 * np.abs(fa[n]).max()
            assert np.abs(fb[n] - fa[n]).max() <= tol, (t, n)
        for n in ("undeformed_x", "undeformed_y", "undeformed_z"):
            assert np.array_equal(fa[n], fb[n]), (t, n)
