"""rdcfes_tpu_torch host layer against rdcfes_tpu: the NumPy copies of the
mesh generator, TET4 tables and sparsity/gather tables are bit-equal to the
reference's, and the port imports no JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import elements as jel
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh

from rdcfes_tpu_torch.fem import assembly, elements
from rdcfes_tpu_torch.mesh import box_tet_mesh
from rdcfes_tpu_torch.utils.convert import (mesh_from_arrays,
                                            state_from_numpy, state_to_numpy)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "rdcfes_tpu_torch"


@pytest.mark.parametrize("shape,bounds", [
    ((2, 2, 2), ((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))),
    ((3, 4, 2), ((0.0, 1.0), (0.0, 2.0), (0.0, 0.5))),
    ((4, 4, 4), ((0, 150.0), (0, 180.0), (0, 150.0))),
])
def test_box_tet_mesh_bit_equal(shape, bounds):
    a = box_tet_mesh(*shape, bounds=bounds)
    b = jax_box_tet_mesh(*shape, bounds=bounds)
    assert a.elem_type == b.elem_type == "TET4"
    for name in ("coords", "connectivity", "subdomain_id", "boundary_faces",
                 "boundary_elem", "boundary_side", "boundary_id"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


def test_tet4_tabulate_bit_equal():
    for x, y in zip(elements.tabulate("TET4"), jel.tabulate("TET4")):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    with pytest.raises(ValueError):
        elements.tabulate("PRISM6")


@pytest.mark.parametrize("n", [2, 3])
def test_sparsity_and_gather_tables_bit_equal(n):
    mesh = box_tet_mesh(n, n + 1, n)
    a = assembly.build_sparsity(mesh.connectivity, mesh.n_nodes)
    b = jasm.build_sparsity(mesh.connectivity, mesh.n_nodes)
    assert a.n_nodes == b.n_nodes and a.nnz == b.nnz
    for name in ("rows", "cols", "slots", "row_ptr", "diag_slots"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for x, y in zip(assembly.gather_tables(a, mesh.connectivity),
                    jasm.gather_tables(b, mesh.connectivity)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_package_imports_no_jax():
    mods = sorted(
        "rdcfes_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                       .parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'rdcfes_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax_import():
    for p in PKG.rglob("*.py"):
        for line in p.read_text().splitlines():
            words = line.split()
            assert not (words[:2] in (["import", "jax"], ["from", "jax"])
                        or line.lstrip().startswith(("import jax",
                                                     "from jax"))), p


def test_mesh_from_arrays_and_state_roundtrip():
    ref = jax_box_tet_mesh(2, 2, 2)
    m = mesh_from_arrays(ref.coords, ref.connectivity, "TET4")
    assert np.array_equal(m.boundary_faces, ref.boundary_faces)
    with pytest.raises(ValueError):
        mesh_from_arrays(ref.coords, ref.connectivity[:, :3], "TET4")
    rng = np.random.default_rng(0)
    g = {k: rng.standard_normal((m.n_nodes, 5))
         for k in ("u", "u_old", "u_older", "u_raw")}
    st = state_from_numpy(g, "cpu")
    assert all(v.dtype == torch.float64 for v in st.values())
    back = state_to_numpy(st)
    assert all(np.array_equal(back[k], g[k]) for k in g)
