"""The port's application IO against rdcfes_tpu's, exactly: the deck
parser, the `.dat` readers, Gmsh read/write, the VTU/PVD writer, the CSV
rows, the mesh summary and volumes, checkpoints written by one package and
read by the other, the generated case directories, the drivers' schedules,
banners and phase log, and the ADPM driver's quadrature interpolation
(within 1e-13 relative to the largest reference value).  No reference
program is compiled here except one tiny eager interpolation."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rdcfes_tpu import cases as jcases
from rdcfes_tpu.drivers import common as jcommon
from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import geometry as jgeo
from rdcfes_tpu.io import csv_metrics as jcsv
from rdcfes_tpu.io import dat as jdat
from rdcfes_tpu.io import getpot as jgetpot
from rdcfes_tpu.io import provenance as jprov
from rdcfes_tpu.io import vtu as jvtu
from rdcfes_tpu.mesh import box_hex_mesh as jax_box_hex_mesh
from rdcfes_tpu.mesh import box_mixed_mesh as jax_box_mixed_mesh
from rdcfes_tpu.mesh import box_tet_mesh as jax_box_tet_mesh
from rdcfes_tpu.mesh import gmsh as jgmsh
from rdcfes_tpu.mesh import tet4_to_tet10 as jax_tet4_to_tet10
from rdcfes_tpu.utils import checkpoint as jckpt

from rdcfes_tpu_torch import cases
from rdcfes_tpu_torch.drivers import common
from rdcfes_tpu_torch.fem import assembly, geometry
from rdcfes_tpu_torch.io import csv_metrics, dat, getpot, provenance, vtu
from rdcfes_tpu_torch.mesh import box_hex_mesh, box_tet_mesh, gmsh
from rdcfes_tpu_torch.utils import checkpoint
from rdcfes_tpu_torch.utils.convert import mesh_from_reference

DECK_TEXT = """# a deck with every syntax the shipped decks use
directory = 'out dir'      # quoted, with a trailing comment
input_GMSH = "mesh # not a comment.msh"
time_step_number = 12
time_step = 1.5e-2
cells_max_capacity = 2.39e+5
int_as_float = 3.0
flag/on = true
flag/off = false
BCs = ' 0 5  7 x 5 '
material/0/Neohookean/Young = 1.0e+4   # misspelled: the code reads Hyperelastic
no equals sign here
   # an indented comment
empty =
"""


def _mesh_pair(kind):
    """(reference mesh, port mesh) with boundary ids 0..5 and two
    subdomains."""
    if kind == "tet":
        ref, port = jax_box_tet_mesh(3, 3, 3), box_tet_mesh(3, 3, 3)
    else:
        b = ((0.0, 1.5), (0.0, 1.0), (0.0, 2.0))
        ref, port = jax_box_hex_mesh(2, 2, 2, bounds=b), box_hex_mesh(
            2, 2, 2, bounds=b)
    for m in (ref, port):
        m.subdomain_id[m.n_elems // 2:] = 7
    return ref, port


def _lookups(d):
    return [d("directory", ""), d("input_GMSH", ""), d("time_step_number", 1),
            d("time_step_number", 1.0), d("time_step", 0.0),
            d("cells_max_capacity", 1.0), d("int_as_float", 0),
            d("flag/on", False), d("flag/off", True), d("BCs", " 0 "),
            d("missing", 4.5), d("missing/int", 3), d("empty", "x"),
            d("material/0/Hyperelastic/Young", 1.0e3),
            d.have("flag/on"), d.have("missing"), sorted(d.keys())]


def test_deck_values_unused_keys_and_warnings():
    a, b = getpot.Deck(io.StringIO(DECK_TEXT)), jgetpot.Deck(
        io.StringIO(DECK_TEXT))
    va, vb = _lookups(a), _lookups(b)
    assert va == vb
    assert [type(v) for v in va] == [type(v) for v in vb]
    assert a.unused_keys() == b.unused_keys() == [
        "material/0/Neohookean/Young"]
    outs = []
    for d in (a, b):
        buf = io.StringIO()
        d.warn("a requested behaviour is not honored", out=buf)
        assert d.warn_unused(out=buf) == ["material/0/Neohookean/Young"]
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "Neohookean/Young = 1.0e+4" in outs[0]
    # a dict source and a file path give the same deck
    da, db = getpot.Deck({"x": 1}), jgetpot.Deck({"x": 1})
    assert da("x", 0) == db("x", 0) == 1 and da.unused_keys() == []


@pytest.mark.parametrize("s", [" 0 5 ", "3 1 x 2 2 -4", "", "1.5 2"])
def test_export_integers(s):
    assert getpot.export_integers(s) == jgetpot.export_integers(s)


def test_dat_readers(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 3))
    p = tmp_path / "stream.dat"
    # layout in the file does not matter, only token order
    p.write_text(" ".join(f"{v:.17g}" for v in a.ravel()[:10]) + "\n"
                 + "\n".join(f"{v:.17g}" for v in a.ravel()[10:]) + "\n")
    x, y = dat.read_stream(str(p), 7, 3), jdat.read_stream(str(p), 7, 3)
    assert x.dtype == y.dtype and np.array_equal(x, y) and np.array_equal(x, a)
    for mod in (dat, jdat):
        with pytest.raises(ValueError, match="expected 24 values"):
            mod.read_stream(str(p), 8, 3)
    q = tmp_path / "rows.dat"
    q.write_text("# header\n\n" + "\n".join(
        " ".join(f"{v:.6g}" for v in row) + " 9" for row in a) + "\n")
    x, y = dat.read_rows_tolerant(str(q), 7, 3), jdat.read_rows_tolerant(
        str(q), 7, 3)
    assert np.array_equal(x, y)
    bad = tmp_path / "bad.dat"
    bad.write_text("1 2 3\n4 five 6\n")
    short = tmp_path / "short.dat"
    short.write_text("1 2 3\n")
    for mod in (dat, jdat):
        with pytest.raises(ValueError, match="failed to read line"):
            mod.read_rows_tolerant(str(bad), 2, 3)
        with pytest.raises(ValueError, match="only 1 of 3 rows"):
            mod.read_rows_tolerant(str(short), 3, 3)


def test_prepare_results_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "input.dat").write_text("x = 1\n")
    (tmp_path / "ic.dat").write_text("1 2\n")
    for mod, d in ((provenance, "a"), (jprov, "b")):
        os.makedirs(d)
        (tmp_path / d / "stale").write_text("")
        assert mod.prepare_results_dir(d, "input.dat",
                                       ["ic.dat", "missing.dat"]) == d
        assert sorted(os.listdir(d)) == ["ic.dat", "input.dat", "stale"]
        mod.prepare_results_dir(d, "input.dat", wipe=True)
        assert sorted(os.listdir(d)) == ["input.dat"]
    assert len(provenance.timestamp_dirname()) == 15


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_gmsh_read_and_write_match_reference(kind, tmp_path):
    ref, port = _mesh_pair(kind)
    text = jgmsh.dumps(ref)
    assert gmsh.dumps(port) == text
    path = str(tmp_path / "m.msh")
    with open(path, "w") as f:
        f.write(text)
    a, b = gmsh.read(path), jgmsh.read(io.StringIO(text))
    c = gmsh.read(io.StringIO(text))
    assert a.elem_type == b.elem_type == c.elem_type
    for name in ("coords", "connectivity", "subdomain_id", "boundary_faces",
                 "boundary_elem", "boundary_side", "boundary_id"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert np.array_equal(getattr(c, name), y), name
    assert set(np.unique(a.boundary_id)) == {0, 1, 2, 3, 4, 5}
    assert gmsh.dumps(a) == text
    # ids in the file are compacted in file order: a shuffled, gapped
    # numbering reads into the same mesh in the reference and the port
    lines = text.splitlines()
    i0 = lines.index("$Nodes") + 2
    n = int(lines[i0 - 1])
    ids = {str(k + 1): str(10 * (n - k) + 3) for k in range(n)}
    for k in range(i0, i0 + n):
        head, rest = lines[k].split(" ", 1)
        lines[k] = ids[head] + " " + rest
    j0 = lines.index("$Elements") + 2
    for k in range(j0, j0 + int(lines[j0 - 1])):
        parts = lines[k].split()
        lines[k] = " ".join(parts[:5] + [ids[p] for p in parts[5:]])
    gapped = "\n".join(lines) + "\n"
    a, b = gmsh.read(io.StringIO(gapped)), jgmsh.read(io.StringIO(gapped))
    assert np.array_equal(a.connectivity, b.connectivity)
    assert np.array_equal(a.boundary_id, b.boundary_id)


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_native_gmsh_parser_matches_numpy_and_reference(kind, tmp_path):
    """A file path goes through the native meshkit parser: its arrays are
    the NumPy parser's and the reference's, sparse ids and subdomains
    included; a file it refuses (here a truncated one, or a mixed mesh)
    falls to the NumPy parser, which says what is wrong."""
    from rdcfes_tpu_torch.native import read_gmsh_native

    ref, _ = _mesh_pair(kind)
    ref.subdomain_id[::3] = 7
    text = jgmsh.dumps(ref)
    path = str(tmp_path / "m.msh")
    with open(path, "w") as f:
        f.write(text)
    a = read_gmsh_native(path)
    for b in (gmsh.read_numpy(path), jgmsh.read(path), gmsh.read(path)):
        assert a.elem_type == b.elem_type
        for name in ("coords", "connectivity", "subdomain_id",
                     "boundary_faces", "boundary_elem", "boundary_side",
                     "boundary_id"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    with open(path, "w") as f:
        f.write(text[: len(text) // 2])
    with pytest.raises(ValueError, match="code"):
        read_gmsh_native(path)
    with pytest.raises(ValueError) as numpy_error:
        gmsh.read_numpy(path)
    with pytest.raises(ValueError, match=str(numpy_error.value)):
        gmsh.read(path)
    # a mixed mesh: the native parser refuses it, the NumPy parser reads
    # it as the reference does
    jgmsh.write(jax_box_mixed_mesh(3, 2, 2), path)
    with pytest.raises(ValueError, match="code"):
        read_gmsh_native(path)
    assert gmsh.dumps(gmsh.read(path)) == jgmsh.dumps(jgmsh.read(path))


def test_gmsh_unsupported_meshes_raise():
    """2D, HEX20, mixed and TET10 meshes read as the reference reads them;
    a TRI6-only and a mixed-type 2D file raise the reference's
    ValueError; malformed files raise ValueError."""
    from rdcfes_tpu.mesh import Mesh as JaxMesh
    from rdcfes_tpu.mesh.generators import box_quad_mesh

    mixed = jgmsh.dumps(jax_box_mixed_mesh(3, 2, 2))
    tet10 = jgmsh.dumps(jax_tet4_to_tet10(jax_box_tet_mesh(1, 1, 1)))
    hex20 = JaxMesh(coords=np.random.default_rng(0).random((20, 3)),
                    connectivity=np.arange(20)[None], elem_type="HEX20",
                    subdomain_id=None)
    for text in (mixed, tet10, jgmsh.dumps(box_quad_mesh(2, 2)),
                 jgmsh.dumps(hex20)):
        assert gmsh.dumps(gmsh.read(io.StringIO(text))) == text
    head = ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n6\n1 0 0 0\n"
            "2 1 0 0\n3 0 1 0\n4 0.5 0 0\n5 0.5 0.5 0\n6 0 0.5 0\n"
            "$EndNodes\n$Elements\n")
    tri6 = head + "1\n1 9 2 1 1 1 2 3 4 5 6\n$EndElements\n"
    mixed2d = head + ("2\n1 2 2 1 1 1 2 6\n2 3 2 1 1 2 5 3 6\n"
                      "$EndElements\n")
    for text, match in ((tri6, "unsupported 2D volume element"),
                        (mixed2d, "mixed-type 2D meshes")):
        with pytest.raises(ValueError, match=match):
            jgmsh.read(io.StringIO(text))
        with pytest.raises(ValueError, match=match):
            gmsh.read(io.StringIO(text))
    for text in ("", "$MeshFormat\n4.1 0 8\n$EndMeshFormat\n",
                 "$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n3\n"):
        with pytest.raises(ValueError):
            gmsh.read(io.StringIO(text))


def _fields(mesh, rng, names):
    return [(n, rng.standard_normal(mesh.n_nodes)
             * 10.0 ** rng.integers(-30, 5, mesh.n_nodes)) for n in names]


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_vtu_and_pvd_series_byte_equal(kind, tmp_path):
    ref, port = _mesh_pair(kind)
    rng = np.random.default_rng(3)
    elem = rng.random(port.n_elems)
    nodal = vtu.elemental_to_nodal(port, elem)
    assert np.array_equal(nodal, jvtu.elemental_to_nodal(ref, elem))
    frames = [(t, _fields(port, rng, ("a", "b")) + [("E", nodal)],
               port.coords + 0.01 * rng.standard_normal(port.coords.shape))
              for t in (0, 5, 10)]
    out = {}
    for tag, mod, m in (("port", vtu, port), ("ref", jvtu, ref)):
        d = tmp_path / tag
        d.mkdir()
        base = str(d / "series")
        w = mod.ParaviewWriter(m)
        w.open_pvd(base)
        for t, f, x in frames[:2]:
            w.update_pvd(f, t, coords=x if t else None)
        w.close_pvd()
        w = mod.ParaviewWriter(m)  # a resumed run keeps the entries
        w.open_pvd(base, resume=True)
        t, f, x = frames[2]
        w.update_pvd(f, t, cell_fields=[("cf", elem)])
        w.close_pvd()
        mod.write_vtu(str(d / "single.vtu"), m, frames[0][1])
        out[tag] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert sorted(out["port"]) == sorted(out["ref"]) == [
        "series-0.vtu", "series-10.vtu", "series-5.vtu", "series.pvd",
        "single.vtu"]
    for name in out["ref"]:
        assert out["port"][name] == out["ref"][name], name
    assert out["ref"]["series.pvd"].count(b"<DataSet") == 3


def test_csv_rows_byte_equal():
    ref, port = _mesh_pair("tet")
    rng = np.random.default_rng(4)
    u5 = 1e3 * rng.random((port.n_nodes, 5))
    params = {"cells_max_capacity": 2.39e3,
              "range_active_tumor_min": 500.0, "range_active_tumor_max": 1e12,
              "range_necrotic_min": 300.0, "range_necrotic_max": 1e12,
              "range_vascularity_min": 1e-12, "range_vascularity_max": 900.0,
              "range_total_cell_min": 0.5, "range_total_cell_max": 1e12}
    u3 = rng.random((port.n_nodes, 3))
    avg = rng.random((port.n_elems, 2))
    ranges = {"range_A_b_min": 0.2, "range_A_b_max": 0.9,
              "range_Tau_min": 1e-12, "range_Tau_max": 0.7}
    out = []
    for mod, m in ((csv_metrics, port), (jcsv, ref)):
        buf = io.StringIO()
        mod.pihna_header(buf)
        mod.pihna_row(buf, m, u5, 0.30000000000000004, params)
        mod.adpm_header(buf, [0, 7])
        mod.adpm_row(buf, m, u3, 1.25, ranges, avg)
        out.append(buf.getvalue())
    assert out[0] == out[1]
    assert len(out[0].splitlines()) == 4


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_element_volumes_and_print_info(kind):
    ref, port = _mesh_pair(kind)
    rng = np.random.default_rng(5)
    c = ref.coords + 0.05 * rng.standard_normal(ref.coords.shape)
    ref.coords, port.coords = c, c.copy()
    a, b = port.element_volumes(), ref.element_volumes()
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port.print_info() == ref.print_info()
    assert np.array_equal(port.subdomain_ids_present(),
                          ref.subdomain_ids_present())


def test_checkpoints_cross_packages(tmp_path):
    rng = np.random.default_rng(6)
    state = {k: rng.random((9, 5)) for k in ("u", "u_old", "u_older",
                                             "u_raw")}
    params = {"dt": 0.1, "decay_a": 5678.4, "name": "x", "n": 3}
    extra = {"uptake": rng.random(4), "structure": rng.random((3, 2))}
    pa, pb = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    checkpoint.save_checkpoint(
        pa, {k: torch.as_tensor(v) for k, v in state.items()}, 7, 0.7,
        params, **extra)
    jckpt.save_checkpoint(pb, state, 7, 0.7, params, **extra)
    for path in (pa, pb):
        for load in (checkpoint.load_checkpoint, jckpt.load_checkpoint):
            st, step, t, ex = load(path, params)
            assert (step, t) == (7, 0.7)
            assert sorted(st) == sorted(state) and sorted(ex) == sorted(extra)
            for k in state:
                assert np.array_equal(st[k], state[k])
            for k in extra:
                assert np.array_equal(ex[k], extra[k])
            with pytest.raises(ValueError, match="different parameters"):
                load(path, {**params, "dt": 0.2})
    assert checkpoint._params_hash(params) == jckpt._params_hash(params)


def test_generated_cases_match_reference(tmp_path):
    for make, jmake in ((cases.make_pihna_case, jcases.make_pihna_case),
                        (cases.make_adpm_case, jcases.make_adpm_case)):
        a, b = tmp_path / ("p" + make.__name__), tmp_path / (
            "r" + make.__name__)
        make(str(a), n=3, n_steps=7)
        jmake(str(b), n=3, n_steps=7)
        names = sorted(p.name for p in b.iterdir())
        assert sorted(p.name for p in a.iterdir()) == names
        for name in names:
            x, y = (a / name).read_text(), (b / name).read_text()
            if name == "Makefile":
                x = x.replace("rdcfes_tpu_torch.cli", "rdcfes_tpu.cli")
            assert x == y, name


def test_schedules_banners_and_phase_log():
    for text in ("output_step = 3", "output_time_points = ' 2 9 4 '", ""):
        a, b = getpot.Deck(io.StringIO(text)), jgetpot.Deck(io.StringIO(text))
        assert common.output_time_points(a, 10) == \
            jcommon.output_time_points(b, 10)
    logs = []
    for mod in (common, jcommon):
        log = mod.PerfLog("x")
        with log.scope("solve"):
            pass
        log.totals["solve"], log.totals["mesh io"] = 1.5, 0.25
        log.counts["mesh io"] = 2
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.step_banner(3, 120, 0.30000000000000004)
            mod.step_banner(1, 2, 0.5, label="pseudo-time")
        log.report(out=buf)
        logs.append(buf.getvalue())
    assert logs[0] == logs[1]


def test_maybe_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("RDCFES_PROFILE", raising=False)
    with common.maybe_profile():
        pass
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv("RDCFES_PROFILE", str(tmp_path / "trace"))
    with common.maybe_profile():
        torch.ones(4).sum()
    assert any(p.name.endswith(".json") for p in (tmp_path / "trace")
               .iterdir())


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_interpolate_at_qp_matches_reference(kind):
    ref, _ = _mesh_pair(kind)
    port = mesh_from_reference(ref)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((3, port.n_nodes))
    conn_T = np.ascontiguousarray(port.connectivity.T)
    phi, _, dphi = geometry.geometry_factors(
        torch.as_tensor(port.coords), torch.as_tensor(port.connectivity),
        port.elem_type)
    a = assembly.interpolate_at_qp(torch.as_tensor(u),
                                   torch.as_tensor(conn_T), phi, dphi)
    jphi, _, jdphi = jgeo.geometry_factors(
        jnp.asarray(ref.coords), jnp.asarray(ref.connectivity), ref.elem_type)
    b = jasm.interpolate_at_qp(jnp.asarray(u), jnp.asarray(conn_T), jphi,
                               jdphi)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.shape == y.shape
        assert np.abs(x.numpy() - y).max() <= 1e-13 * np.abs(y).max()
