"""The port's process_mesh driver, its mesh transforms and its ExodusII
writer against rdcfes_tpu:

* rotation_matrix, transform_mesh (scale, then translate, then rotate)
  and Mesh.with_coords within 1e-15 of the reference's, on TET4 and HEX8;
  the written `.msh` re-reads at the transformed coordinates to the six
  significant digits the Gmsh writer prints;
* both drivers, fed the same answers on stdin in their own directories:
  the `.msh` and the `.config` byte-equal, the `.ex2` files equal in every
  dimension, variable and attribute on re-read but the title, and the
  prompts on stdout equal;
* a failed ExodusII export prints a NOTE to stderr and the driver goes
  on; a TET10 mesh exports one TETRA10 block (mixed and TET10 meshes
  through both drivers: tests/test_torch_mixed_drivers.py).
"""

import io
import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from rdcfes_tpu.drivers import process_mesh as jprocess
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.mesh import transform as jtransform

from rdcfes_tpu_torch.drivers import process_mesh
from rdcfes_tpu_torch.io import exodus
from rdcfes_tpu_torch.mesh import gmsh, transform
from rdcfes_tpu_torch.utils.convert import mesh_from_reference

# input, scale, translation x/y/z, rotation x/y/z, renumbering, output
ANSWERS = "in.msh\n2\n1.5\n-2\n0.25\n30\n45\n60\n1\nout\n"


def _meshes():
    for jm in (jax_box_tet_mesh(2, 3, 2), jax_box_hex_mesh(2, 2, 3)):
        jm.boundary_id[:] = np.arange(len(jm.boundary_id)) % 4
        yield jm, mesh_from_reference(jm)


def test_transforms_match_reference():
    for angles in ((0.3, -1.1, 2.0), (0.0, 0.0, 0.0)):
        a = transform.rotation_matrix(*angles)
        b = jtransform.rotation_matrix(*angles)
        assert np.abs(a - b).max() <= 1e-15
    for jm, m in _meshes():
        kw = dict(scale=2.0, translate=(1.5, -2.0, 0.25),
                  rotate_deg=(30.0, 45.0, 60.0))
        out, ref = transform.transform_mesh(m, **kw), \
            jtransform.transform_mesh(jm, **kw)
        assert np.abs(out.coords - ref.coords).max() <= 1e-15 * np.abs(
            ref.coords).max()
        assert np.array_equal(out.connectivity, ref.connectivity)
        assert np.array_equal(out.boundary_id, m.boundary_id)
        moved = m.with_coords(m.coords + 1.0)
        assert np.array_equal(moved.coords, jm.with_coords(
            jm.coords + 1.0).coords)
        assert moved.coords.dtype == np.float64 and np.array_equal(
            m.coords, jm.coords)  # the original is untouched


def _drive(run, d, monkeypatch, capsys):
    monkeypatch.chdir(d)
    monkeypatch.setattr("sys.stdin", io.StringIO(ANSWERS))
    run()
    return capsys.readouterr()


def _netcdf(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return (dict(f.dimensions),
                {k: (v.dimensions, np.array(v[:]), dict(v._attributes))
                 for k, v in f.variables.items()},
                {k: v for k, v in f._attributes.items() if k != "title"})


@pytest.mark.parametrize("which", [0, 1], ids=["TET4", "HEX8"])
def test_process_mesh_matches_reference(which, tmp_path, monkeypatch,
                                        capsys):
    jm, _ = list(_meshes())[which]
    outs = {}
    for name, run in (("ref", jprocess.run), ("port", process_mesh.run)):
        d = tmp_path / name
        d.mkdir()
        jgmsh.write(jm, str(d / "in.msh"))
        outs[name] = _drive(run, d, monkeypatch, capsys)
    assert outs["port"].out == outs["ref"].out
    assert "NOTE" not in outs["port"].err
    for ext in (".msh", ".config"):
        a = (tmp_path / "ref" / ("out" + ext)).read_bytes()
        assert (tmp_path / "port" / ("out" + ext)).read_bytes() == a, ext
    dims, var, attrs = _netcdf(str(tmp_path / "port" / "out.ex2"))
    rdims, rvar, rattrs = _netcdf(str(tmp_path / "ref" / "out.ex2"))
    assert dims == rdims and attrs == rattrs and sorted(var) == sorted(rvar)
    for k, (shape, arr, at) in var.items():
        assert shape == rvar[k][0] and at == rvar[k][2], k
        assert np.array_equal(arr, rvar[k][1]), k
    # the .msh re-reads at the transformed coordinates, to the 6
    # significant digits that the Gmsh writer prints (as the reference's)
    back = gmsh.read(str(tmp_path / "port" / "out.msh"))
    want = transform.transform_mesh(gmsh.read(str(tmp_path / "port" /
                                              "in.msh")), 2.0,
                                    (1.5, -2.0, 0.25), (30.0, 45.0, 60.0))
    np.testing.assert_allclose(back.coords, want.coords, rtol=1e-5,
                               atol=1e-12)
    assert np.array_equal(back.boundary_id, jm.boundary_id)


def test_failed_exodus_export_goes_on(tmp_path, monkeypatch, capsys):
    jm, m = next(_meshes())
    jgmsh.write(jm, str(tmp_path / "in.msh"))

    def fail(path, mesh):
        raise OSError("disk full")

    monkeypatch.setattr(process_mesh, "write_exodus", fail)
    res = _drive(process_mesh.run, tmp_path, monkeypatch, capsys)
    assert "NOTE: ExodusII export skipped (disk full)" in res.err
    assert {"out.msh", "out.config"} <= set(os.listdir(tmp_path))
    assert "out.ex2" not in os.listdir(tmp_path)
    # a TET10 mesh, which raised until its export was ported, writes one
    # TETRA10 block
    from rdcfes_tpu.mesh import tet4_to_tet10

    tet10 = mesh_from_reference(tet4_to_tet10(jm))
    exodus.write_exodus(str(tmp_path / "x.ex2"), tet10)
    with netcdf_file(str(tmp_path / "x.ex2"), "r", mmap=False) as f:
        assert f.variables["connect1"].elem_type == b"TETRA10"
        assert f.variables["connect1"].shape == (tet10.n_elems, 10)
