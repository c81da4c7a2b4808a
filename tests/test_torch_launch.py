"""The kernels' launch path on the CPU: the C entry points bound in
fem/_build.py against the prototypes of csrc/*.cu, the launch data that K3
and K6 plans are made from against the tables the wrappers used to build
on every call, and the once-per-step checks of the tables and stacks.

No JAX and no card: every case runs in a few milliseconds.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from rdcfes_tpu_torch.fem import _build, elements, kernels
from rdcfes_tpu_torch.fem.weakform import WeakFormBlocks

PROTO = re.compile(r'extern "C" int (rdc_\w+)\(([^)]*)\)')


def _prototypes():
    """name -> ["P" or "I" per argument] of every extern "C" entry point."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, args in PROTO.findall(src.read_text()):
            kinds = []
            for a in args.split(","):
                a = " ".join(a.split())
                assert "*" in a or a.startswith("int "), (name, a)
                kinds.append("P" if "*" in a else "I")
            out[name] = kinds
    return out


PROTOTYPES = _prototypes()


def test_every_entry_point_is_bound():
    assert set(PROTOTYPES) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_prototype(name):
    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I"}
    assert [kind[t] for t in _build.SIGNATURES[name]] == PROTOTYPES[name]


def _stacks(kind, V, seed, E=7):
    """Stacks of a seeded random live (v, w) pattern (about half of the
    blocks live, one species with none when V > 1), with element tables
    of matching shapes: TET4 (K 4, Q 5) for "affine", HEX8 for
    "generic"."""
    rng = np.random.default_rng(seed)
    K, Q = (4, 5) if kind == "affine" else (8, 8)
    live = rng.random((3, V, V)) < 0.5
    if V > 1:
        live[:, V - 1, :] = False
    rnd = lambda *shape: torch.as_tensor(rng.standard_normal(shape))
    table = lambda t, tail: [[rnd(*tail) if live[t, v, w] else 0.0
                              for w in range(V)] for v in range(V)]
    A = tuple(rnd(Q, E) for _ in range(V))
    wfb = WeakFormBlocks(A=A, B=(0.0,) * V, C=table(0, (Q, E)),
                         D=table(1, (Q, 3, E)), E=table(2, (Q, E)))
    if kind == "affine":
        st = kernels.stack_apply(wfb, table(2, (E,)))
        dphi = rnd(K, 3, E)
    else:
        st = kernels.stack_apply_generic(wfb)
        dphi = rnd(Q, K, 3, E)
    conn_T = torch.as_tensor(rng.integers(0, 20, (K, E)), dtype=torch.int32)
    phi = rng.random((Q, K))
    return st, conn_T, phi, rnd(Q, E), dphi, live


def _per_call_slots(st):
    """The slot table as the wrappers built it on every call."""
    slots = np.full((3, kernels.MAX_V, kernels.MAX_V), -1, np.int32)
    for t, idx in enumerate((st.idxC, st.idxD, st.idxE)):
        for i, (v, w) in enumerate(idx):
            slots[t, v, w] = i
    return slots


@pytest.mark.parametrize("V", [1, 3, 5, 8])
@pytest.mark.parametrize("kind", ["affine", "generic"])
def test_launch_data_slots_equal_per_call_tables(kind, V):
    st, conn_T, phi, JxW, dphi, live = _stacks(kind, V, seed=10 * V)
    d = kernels.apply_launch_data(kind, conn_T, phi, JxW, dphi, st, 20)
    assert d.slots.dtype == np.int32 and d.slots.flags.c_contiguous
    assert np.array_equal(d.slots, _per_call_slots(st))
    assert np.array_equal(d.slots[:, :V, :V] >= 0, live)
    assert (d.V, d.N, d.E, d.dtype) == (V, 20, 7, torch.float64)


@pytest.mark.parametrize("elem_type", ["TET4", "HEX8"])
def test_launch_data_phi_equals_per_call_table(elem_type):
    kind = "affine" if elem_type == "TET4" else "generic"
    st, conn_T, _, JxW, dphi, _ = _stacks(kind, 3, seed=1)
    phi = elements.tabulate(elem_type)[0]
    d = kernels.apply_launch_data(kind, conn_T, phi, JxW, dphi, st, 20)
    assert d.phi.dtype == np.float64 and d.phi.flags.c_contiguous
    assert np.array_equal(d.phi, np.ascontiguousarray(phi, np.float64))
    assert (d.Q, d.K) == phi.shape


def test_stacks_keep_their_own_plans():
    a = _stacks("generic", 2, seed=3)[0]
    b = _stacks("generic", 2, seed=3)[0]
    assert a.plans == {} and b.plans == {} and a.plans is not b.plans


def _bad(kind, what):
    """Launch-data arguments with one tensor wrong."""
    st, conn_T, phi, JxW, dphi, _ = _stacks(kind, 3, seed=2)
    if what == "conn_T dtype":
        conn_T = conn_T.long()
    elif what == "JxW dtype":
        JxW = JxW.to(torch.int32)
    elif what == "dphi shape":
        dphi = dphi[..., :-1].contiguous()
    elif what == "dphi contiguity":
        dphi = dphi.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif what == "stacks dtype":
        JxW, dphi = JxW.float(), dphi.float()
    elif what == "stacks shape":
        st = st._replace(D=st.D[..., :-1])
    elif what == "species":
        st = st._replace(n_vars=kernels.MAX_V + 1)
    return kind, conn_T, phi, JxW, dphi, st, 20


@pytest.mark.parametrize("kind,what,err,match", [
    ("generic", "conn_T dtype", TypeError, "conn_T"),
    ("generic", "JxW dtype", TypeError, "no kernel"),
    ("generic", "dphi shape", ValueError, "dphi: shape"),
    ("generic", "dphi contiguity", ValueError, "contiguous"),
    ("generic", "stacks dtype", TypeError, "C: dtype"),
    ("generic", "stacks shape", ValueError, "D: shape"),
    ("generic", "species", ValueError, "species"),
    ("affine", "dphi shape", ValueError, "dphi: shape"),
    ("affine", "stacks dtype", TypeError, "C: dtype"),
])
def test_launch_data_raises(kind, what, err, match):
    with pytest.raises(err, match=match):
        kernels.apply_launch_data(*_bad(kind, what))


def test_generic_launch_data_takes_only_built_elements():
    st, conn_T, phi, JxW, dphi, _ = _stacks("affine", 3, seed=4)
    with pytest.raises(ValueError, match="K=4, Q=5"):
        kernels.apply_launch_data("generic", conn_T, phi, JxW, dphi, st, 20)


@pytest.mark.parametrize("table,err,match", [
    (lambda t: t.long(), TypeError, "int32"),
    (lambda t: t.reshape(-1), ValueError, "shape"),
    (lambda t: t.T.contiguous().T, ValueError, "contiguous"),
    (lambda t: t, None, None),
])
def test_restrict_table_checks(table, err, match):
    ng = torch.as_tensor(np.arange(24, dtype=np.int32).reshape(4, 6))
    if err is None:
        assert kernels.restrict_table(table(ng)) == (4, 6)
    else:
        with pytest.raises(err, match=match):
            kernels.restrict_table(table(ng))
