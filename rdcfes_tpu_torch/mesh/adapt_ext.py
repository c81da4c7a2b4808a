"""AMR on TET10 and MIXED meshes (host NumPy copy of
rdcfes_tpu.mesh.adapt_ext, the same meshes, constraints and transfers).

libMesh's `MeshRefinement` refines whatever mesh was loaded (C++
reference src/pihna.C:805-840); the TET4 strategies are mesh/adapt.py
(bisection) and mesh/constrain.py (1:8 with hanging nodes).  This module
carries them to the other mesh kinds of the PIHNA driver:

TET10: the corner skeleton refines by bisection, the refined skeleton is
upgraded to second order again (mesh/generators.tet4_to_tet10), and the
solution transfers exactly for any quadratic field: each new node takes
the old TET10 field at its position (host point location over the old
skeleton, then the TET10 basis).  The result is conforming, with no
hanging nodes; the driver's "1to8" strategy falls back to bisection on
TET10 with a printed notice.

MIXED: the TET4 block refines 1:8 with hanging nodes while the other
blocks (HEX8, PRISM6, PYRAMID5) stay as they are: a mid-edge node on an
edge shared with such a block hangs against its endpoints with the same
P1 constraint as on TET4, and a refinement whose closure would need such
a block to split is vetoed (ConstrainedMesh.frozen_edges).  Every block
is P1, so the constraints are the rows [h, a, b] of the TET4 path.

The device systems are rebuilt on the new mesh afterwards, as after
mesh/refine.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np

from .adapt import AdaptiveMesh, AdaptResult
from .constrain import ConstrainedMesh
from .core import Mesh, MeshBlock, MixedMesh

# element edges per type (corner-node local indices): the frozen edges of
# the blocks that do not refine
_EDGES = {
    "TET4": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
    "HEX8": [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)],
    "PRISM6": [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3),
               (0, 3), (1, 4), (2, 5)],
    "PYRAMID5": [(0, 1), (1, 2), (2, 3), (3, 0),
                 (0, 4), (1, 4), (2, 4), (3, 4)],
}


# ----------------------------------------------------------------------
# TET10
# ----------------------------------------------------------------------
def tet10_skeleton(mesh: Mesh):
    """The corner TET4 skeleton of a TET10 mesh: (skel, corner_ids), skel
    a TET4 Mesh over the renumbered corner nodes, corner_ids[i] the TET10
    node id of skeleton node i.  Boundary ids carry over by corner-face
    key."""
    assert mesh.elem_type == "TET10", mesh.elem_type
    conn4 = mesh.connectivity[:, :4].astype(np.int64)
    corner_ids = np.unique(conn4)
    old2skel = np.full(mesh.n_nodes, -1, dtype=np.int64)
    old2skel[corner_ids] = np.arange(len(corner_ids))
    skel = Mesh(mesh.coords[corner_ids],
                old2skel[conn4].astype(np.int32), "TET4",
                mesh.subdomain_id.copy())
    if mesh.boundary_id is not None and len(mesh.boundary_faces):
        old = {tuple(sorted(int(x) for x in f[:3])): int(b)
               for f, b in zip(mesh.boundary_faces, mesh.boundary_id)}
        for i, f in enumerate(skel.boundary_faces):
            bid = old.get(tuple(sorted(int(corner_ids[x]) for x in f)))
            if bid is not None:
                skel.boundary_id[i] = bid
    return skel, corner_ids


def quadratic_transfer(old: Mesh, new_coords: np.ndarray):
    """The old TET10 field evaluated at each point of new_coords (M, 3):
    returns u_old (N_old, ...) -> u_new (M, ...).  Exact for any field of
    the old space: each point is located in an old element (k-d tree
    candidates, then barycentric containment) and the element's 10
    quadratic shape functions are evaluated there, libMesh's embedding
    prolongation at arbitrary target points (so coarsening transfers
    too)."""
    from scipy.spatial import cKDTree

    from ..fem.elements import shape_functions

    assert old.elem_type == "TET10"
    conn = old.connectivity.astype(np.int64)
    X = old.coords[conn[:, :4]]                      # (E, 4, 3) corners
    tree = cKDTree(X.mean(axis=1))
    P = np.asarray(new_coords, dtype=np.float64)
    M = P.shape[0]
    _, cand = tree.query(P, k=min(24, len(X)))
    cand = np.atleast_2d(cand)
    T = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))  # (E, 3, 3) cols=edges
    Tinv = np.linalg.inv(T)

    elem_of = np.full(M, -1, dtype=np.int64)
    bary = np.zeros((M, 3))
    todo = np.arange(M)
    for j in range(cand.shape[1]):
        if not todo.size:
            break
        e = cand[todo, j]
        lam = np.einsum("mij,mj->mi", Tinv[e], P[todo] - X[e, 0])
        ok = (lam.min(axis=1) >= -1e-8) & (lam.sum(axis=1) <= 1 + 1e-8)
        hit = todo[ok]
        elem_of[hit] = e[ok]
        bary[hit] = lam[ok]
        todo = todo[~ok]
    if todo.size:
        # points no candidate contains (slivers): the nearest candidate's
        # clipped barycentrics, still a convex evaluation
        e = cand[todo, 0]
        lam = np.einsum("mij,mj->mi", Tinv[e], P[todo] - X[e, 0])
        lam = np.clip(lam, 0.0, 1.0)
        s = lam.sum(axis=1, keepdims=True)
        lam = np.where(s > 1.0, lam / s, lam)
        elem_of[todo] = e
        bary[todo] = lam

    N10 = shape_functions("TET10", bary)             # (M, 10)
    src = conn[elem_of]                              # (M, 10)

    def transfer(u):
        u = np.asarray(u)
        return np.einsum("mk,mk...->m...", N10, u[src])

    return transfer


@dataclass
class Tet10Adaptive:
    """A TET10 mesh and the bisection forest of its corner skeleton.  It
    refines and coarsens as an AdaptiveMesh does, so adapt.adapt_flagged
    takes either."""

    mesh: Mesh
    skel: AdaptiveMesh

    @classmethod
    def from_mesh(cls, mesh: Mesh) -> "Tet10Adaptive":
        skel, _ = tet10_skeleton(mesh)
        return cls(mesh, AdaptiveMesh(skel))

    def refine_and_coarsen(self, refine_flags: np.ndarray,
                           coarsen_flags: np.ndarray,
                           max_level: int = 3
                           ) -> Optional[AdaptResult]:
        """The skeleton's AdaptResult, carried over to TET10: the new
        Tet10Adaptive, the quadratic nodal transfer, the elem_map."""
        from .generators import tet4_to_tet10

        r = self.skel.refine_and_coarsen(refine_flags, coarsen_flags,
                                         max_level=max_level)
        if r is None:
            return None
        new10 = tet4_to_tet10(r.adaptive.mesh)
        return AdaptResult(Tet10Adaptive(new10, r.adaptive),
                           quadratic_transfer(self.mesh, new10.coords),
                           r.elem_map)


# ----------------------------------------------------------------------
# MIXED
# ----------------------------------------------------------------------
class MixedAdaptOutcome(NamedTuple):
    """refine_and_coarsen on a MixedMesh's TET4 block, with the fields of
    constrain.ConstrainedRACResult that the driver reads; constraints
    are the (H, 3) rows [h, a, b] (u_h = (u_a + u_b) / 2) of the new
    mesh, for the transient system's `constraints=`."""

    mesh: MixedMesh
    constrained: "MixedConstrained"
    prolong: Callable[[np.ndarray], np.ndarray]
    transfer_elemental: Callable[[np.ndarray], np.ndarray]
    constraints: np.ndarray


@dataclass
class MixedConstrained:
    """A MixedMesh whose TET4 block (the first, if several) refines 1:8
    with hanging nodes.  The ConstrainedMesh inside holds all the mixed
    mesh's coords with the TET4 block's connectivity, so node ids,
    prolongation and constraints are global; the other blocks give it
    its frozen_edges and pinned_nodes."""

    mixed: MixedMesh
    tet_idx: int
    cmesh: ConstrainedMesh

    @classmethod
    def from_mesh(cls, mixed: MixedMesh) -> "MixedConstrained":
        tet_idx = [i for i, b in enumerate(mixed.blocks)
                   if b.elem_type == "TET4"]
        assert tet_idx, "MIXED AMR needs a TET4 block to refine"
        ti = tet_idx[0]
        edges, pinned = [np.zeros((0, 2), np.int64)], [np.zeros(0, np.int64)]
        for i, b in enumerate(mixed.blocks):
            if i == ti:
                continue
            conn = b.connectivity.astype(np.int64)
            ev = np.sort(conn[:, np.array(_EDGES[b.elem_type])], axis=-1)
            edges.append(ev.reshape(-1, 2))
            pinned.append(conn.reshape(-1))
        tb = mixed.blocks[ti]
        tet_mesh = Mesh(mixed.coords.copy(), tb.connectivity.copy(), "TET4",
                        tb.subdomain_id.copy())
        cm = ConstrainedMesh(
            tet_mesh,
            frozen_edges=np.unique(np.concatenate(edges), axis=0),
            pinned_nodes=np.unique(np.concatenate(pinned)))
        return cls(mixed, ti, cm)

    # a ConstrainedMesh's interface: the mesh, its constraint rows and
    # its live hanging set (what a checkpoint restores)
    @property
    def mesh(self) -> MixedMesh:
        return self.mixed

    @property
    def constraints(self) -> np.ndarray:
        return self.cmesh.constraints

    @property
    def hanging(self):
        return self.cmesh.hanging

    @hanging.setter
    def hanging(self, value):
        self.cmesh.hanging = value

    def refine_and_coarsen(self, refine_flags: np.ndarray,
                           coarsen_flags: np.ndarray,
                           max_level: int = 3
                           ) -> Optional[MixedAdaptOutcome]:
        """Flags over the global (block-concatenated) element order; only
        the TET4 block's slice acts."""
        off = sum(b.n_elems for b in self.mixed.blocks[:self.tet_idx])
        nt = self.mixed.blocks[self.tet_idx].n_elems
        rf = np.asarray(refine_flags, dtype=bool)[off:off + nt]
        cf = np.asarray(coarsen_flags, dtype=bool)[off:off + nt]
        r = self.cmesh.refine_and_coarsen(rf, cf, max_level=max_level)
        if r is None:
            return None
        cm2 = r.constrained
        kept = r.kept_nodes

        # the other blocks' connectivity is remapped through `kept` when
        # coarsening renumbered (their nodes are pinned, so always kept)
        if kept is not None:
            old2new = np.full(self.mixed.coords.shape[0], -1,
                              dtype=np.int64)
            old2new[kept] = np.arange(len(kept))
        blocks = []
        for i, b in enumerate(self.mixed.blocks):
            if i == self.tet_idx:
                blocks.append(MeshBlock(
                    "TET4", cm2.mesh.connectivity.copy(),
                    cm2.mesh.subdomain_id.copy()))
            elif kept is not None:
                conn = old2new[b.connectivity.astype(np.int64)]
                assert (conn >= 0).all(), "frozen-block node dropped"
                blocks.append(MeshBlock(b.elem_type, conn.astype(np.int32),
                                        b.subdomain_id.copy()))
            else:
                blocks.append(b)
        new_mixed = MixedMesh(cm2.mesh.coords.copy(), blocks)
        # boundary ids: an unchanged face keeps its old id by corner key
        # (in the new numbering); a split tet face takes the id that the
        # TET4 mesh inside propagated
        idmap = {}
        remap = ((lambda x: int(old2new[x])) if kept is not None
                 else (lambda x: int(x)))
        if self.mixed.boundary_id is not None:
            for f, bid in zip(self.mixed.boundary_faces,
                              self.mixed.boundary_id):
                key = tuple(sorted(remap(x) for x in f if x >= 0))
                if all(k >= 0 for k in key):
                    idmap[key] = int(bid)
        if cm2.mesh.boundary_id is not None:
            for f, bid in zip(cm2.mesh.boundary_faces,
                              cm2.mesh.boundary_id):
                idmap.setdefault(tuple(sorted(int(x) for x in f)), int(bid))
        for i, f in enumerate(new_mixed.boundary_faces):
            bid = idmap.get(tuple(sorted(int(x) for x in f if x >= 0)))
            if bid is not None:
                new_mixed.boundary_id[i] = bid

        te = r.transfer_elemental

        def transfer_elemental(vals):
            vals = np.asarray(vals)
            return np.concatenate([vals[:off], te(vals[off:off + nt]),
                                   vals[off + nt:]], axis=0)

        return MixedAdaptOutcome(new_mixed,
                                 MixedConstrained(new_mixed, self.tet_idx,
                                                  cm2),
                                 r.prolong, transfer_elemental,
                                 cm2.constraints)


def kelly_mixed(mixed: MixedMesh, u, variables, tet_idx: int = None):
    """The Kelly indicator over a MixedMesh in the global element order,
    on the TET4 block only (face jumps within the block; the other blocks
    never refine, so their indicator could only force vetoed flags, and
    they report 0)."""
    from ..fem.amr import kelly_error_indicator

    if tet_idx is None:
        tet_idx = next(i for i, b in enumerate(mixed.blocks)
                       if b.elem_type == "TET4")
    out = np.zeros(mixed.n_elems)
    off = 0
    for i, b in enumerate(mixed.blocks):
        if i == tet_idx:
            tet_mesh = Mesh(mixed.coords.copy(), b.connectivity.copy(),
                            "TET4", b.subdomain_id.copy())
            out[off:off + b.n_elems] = kelly_error_indicator(
                tet_mesh, u, variables)
        off += b.n_elems
    return out
