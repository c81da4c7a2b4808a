"""Selective 1:8 TET4 refinement with hanging-node constraints, and its
coarsening (host NumPy copy of rdcfes_tpu.mesh.constrain, the same
arrays).

The "1to8" strategy of the PIHNA driver, libMesh's own
(`MeshRefinement::refine_and_coarsen_elements` +
`DofMap::constrain_element_matrix_and_vector`, C++ reference
src/pihna.C:752, :805-840): flagged elements split 1:8, and a mid-edge
node whose edge still belongs to an unrefined element hangs, with the P1
constraint u_h = (u_a + u_b) / 2.  The transient system solves the
constrained operator C^T A C matrix-free (systems/transient.py
`constraints=`).

Chained constraints are excluded by libMesh's level-one rule: refining
an element that holds a hanging node forces the coarse owners of that
node's edge to refine in the same pass (flag closure), so both ends of
every constraint are master dofs.

Coarsening mirrors libMesh's `_coarsen_elements`: the refinement forest
is kept per sibling group (the 8 children of one split); a group whose
children are all active and all flagged collapses to its recorded
parent, orphaned mid-edge nodes are dropped, and the hanging set is
recomputed.  Collapses that would break the level-one rule are vetoed.

The same meshes, constraint rows and transfers as the reference's; the
closure, the veto sweep and the coarsening checks look edges up in a
sorted table of edge keys instead of scanning the connectivity once per
hanging node, so a pass costs O(E log E), not O(H E).

`frozen_edges` and `pinned_nodes` serve the MIXED meshes
(mesh/adapt_ext.MixedConstrained): the edges and nodes of blocks outside
this TET4 mesh that never refine.  A mid-edge node on a frozen edge
hangs for good, a flagged element whose closure would need a frozen
owner to split is vetoed instead, and coarsening never drops a pinned
node.  The frozen edges join the same sorted key tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .core import Mesh
from .refine import _propagate_boundary, _tri_children, _unique_rows

_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


class ConstrainedAdaptResult(NamedTuple):
    constrained: "ConstrainedMesh"
    prolong: Callable[[np.ndarray], np.ndarray]
    elem_map: np.ndarray


class ConstrainedRACResult(NamedTuple):
    """refine_and_coarsen: composed nodal + elemental transfers.

    kept_nodes: when the pass coarsened, (N_kept,) old node id per new
    node (refinement appends nodes AFTER these, ids stable); None when
    no renumbering happened.  MixedConstrained remaps its other blocks'
    connectivity through it."""

    constrained: "ConstrainedMesh"
    prolong: Callable[[np.ndarray], np.ndarray]          # nodal old->new
    transfer_elemental: Callable[[np.ndarray], np.ndarray]
    kept_nodes: Optional[np.ndarray] = None


@dataclass
class _Group:
    """One 1:8 split: the recorded parent of an 8-child sibling group
    (the refinement-forest node libMesh keeps as Elem::parent())."""

    parent_conn: np.ndarray   # (4,) parent corner node ids
    mids: np.ndarray          # (6,) mid-edge node ids, _TET_EDGES order
    subdomain: int
    parent_group: int         # group the parent itself belongs to (-1 root)
    parent_level: int         # refinement level of the parent
    bfaces: List[Tuple[Tuple[int, int, int], int]]  # parent boundary faces


def _edge_keys(conn: np.ndarray, n_nodes: int) -> np.ndarray:
    """(E, 6) int64 key lo * n_nodes + hi of every element edge."""
    e = conn[:, _TET_EDGES]
    return (np.minimum(e[..., 0], e[..., 1]) * n_nodes
            + np.maximum(e[..., 0], e[..., 1]))


def _pair_keys(pairs, n_nodes: int) -> np.ndarray:
    """int64 keys of node pairs (M, 2), in either order."""
    p = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    return np.minimum(p[:, 0], p[:, 1]) * n_nodes + np.maximum(p[:, 0],
                                                               p[:, 1])


def _expand(order: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """order[lo[i]:hi[i]] for every i, concatenated, and each entry's i."""
    cnt = hi - lo
    grp = np.repeat(np.arange(len(lo)), cnt)
    start = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    return order[np.arange(int(cnt.sum())) + start], grp


class _SortedTable:
    """A flat key array sorted, so that the entries of one key are one
    contiguous range."""

    def __init__(self, flat: np.ndarray):
        self.order = np.argsort(flat, kind="stable")
        self.keys = flat[self.order]

    def ranges(self, keys: np.ndarray):
        return (np.searchsorted(self.keys, keys, "left"),
                np.searchsorted(self.keys, keys, "right"))

    def entries(self, keys: np.ndarray):
        """(flat index, i) for every entry of every keys[i]."""
        return _expand(self.order, *self.ranges(keys))


class _EdgeTable(_SortedTable):
    """The elements around each edge: the (E * 6) element-edge keys
    sorted, so that the owners of an edge are one contiguous range."""

    def __init__(self, conn: np.ndarray, n_nodes: int):
        super().__init__(_edge_keys(conn, n_nodes).reshape(-1))

    def owners(self, keys: np.ndarray) -> np.ndarray:
        """Elements holding any of the edges `keys` (ascending, unique)."""
        return np.unique(self.entries(keys)[0] // 6)

    def count(self, keys: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Per edge in `keys`, the owners with mask (E,) set."""
        cs = np.concatenate([[0], np.cumsum(mask[self.order // 6])])
        lo, hi = self.ranges(keys)
        return cs[hi] - cs[lo]


@dataclass
class ConstrainedMesh:
    """A TET4 mesh plus its live hanging-node constraints and forest.

    hanging maps a sorted edge (a, b) -> the mid-edge node id h carrying
    the constraint u_h = (u_a + u_b) / 2.  Both endpoints are always
    master dofs (flag closure, module docstring).  groups/elem_group/
    elem_level are the refinement forest that enables coarsening; a
    ConstrainedMesh rebuilt from a checkpoint has an empty forest, so
    pre-crash refinements cannot coarsen (same documented limitation as
    the bisection strategy's forest)."""

    mesh: Mesh
    hanging: Dict[Tuple[int, int], int] = field(default_factory=dict)
    groups: Dict[int, _Group] = field(default_factory=dict)
    elem_group: Optional[np.ndarray] = None  # (E,) sibling group, -1 root
    elem_level: Optional[np.ndarray] = None  # (E,) refinement level
    # MIXED meshes: (F, 2) sorted node pairs, ascending, of the edges of
    # the blocks outside this mesh, and (P,) their node ids
    frozen_edges: Optional[np.ndarray] = None
    pinned_nodes: Optional[np.ndarray] = None

    def __post_init__(self):
        E = self.mesh.n_elems
        if self.elem_group is None:
            self.elem_group = np.full(E, -1, dtype=np.int64)
        if self.elem_level is None:
            self.elem_level = np.zeros(E, dtype=np.int64)

    def _frozen_keys(self, n_nodes: int) -> np.ndarray:
        """The frozen edges' keys at n_nodes, ascending."""
        if self.frozen_edges is None:
            return np.zeros(0, dtype=np.int64)
        return _pair_keys(self.frozen_edges, n_nodes)

    @property
    def constraints(self) -> np.ndarray:
        """(H, 3) int32 rows [h, a, b] (H may be 0)."""
        if not self.hanging:
            return np.zeros((0, 3), dtype=np.int32)
        rows = [(h, a, b) for (a, b), h in sorted(self.hanging.items())]
        return np.asarray(rows, dtype=np.int32)

    # ------------------------------------------------------------------
    def refine(self, flags: np.ndarray, max_level: Optional[int] = None):
        """Split flagged elements 1:8; returns ConstrainedAdaptResult or
        None when nothing is flagged.  max_level caps the refinement
        depth (libMesh max_h_level); closure-forced splits may exceed it,
        as libMesh's level-one rule does."""
        mesh = self.mesh
        assert mesh.elem_type == "TET4", "constrained 1:8 is TET4-only"
        conn = mesh.connectivity.astype(np.int64)
        E, N = conn.shape[0], mesh.n_nodes
        S = np.asarray(flags, dtype=bool).copy()
        if max_level is not None:
            S &= self.elem_level < int(max_level)
        if not S.any():
            return None

        # ---- flag closure: no chained constraints ---------------------
        # refining an element with a hanging corner h forces the coarse
        # owners of h's edge (the unrefined elements containing that
        # edge) to refine too
        if self.hanging:
            edges = _EdgeTable(conn, N)
            hang = np.fromiter(self.hanging.values(), dtype=np.int64)
            hkeys = _pair_keys(list(self.hanging), N)
            key_of = np.full(N, -1, dtype=np.int64)
            key_of[hang] = hkeys
            # a hanging node on a frozen edge can never become free:
            # refining an element that holds it would chain constraints,
            # so the closure vetoes its flagged holders instead
            hfrozen = np.isin(hkeys, self._frozen_keys(N))
            frozen_of = np.zeros(N, dtype=bool)
            frozen_of[hang] = hfrozen
            # node -> elements, needed only to veto frozen holders
            holders = (_SortedTable(conn.reshape(-1)) if hfrozen.any()
                       else None)
            for _ in range(64):  # closure terminates long before this
                corners = conn[S]
                hs = np.unique(corners[np.isin(corners, hang)])
                if not hs.size:
                    break
                # the reference walks hs in order, each h forcing its
                # edge's owners in or vetoing its frozen holders out:
                # an element ends as the last h that touched it says
                thaw = ~frozen_of[hs]
                e1, g1 = edges.entries(key_of[hs[thaw]])
                e2, g2 = (holders.entries(hs[~thaw]) if holders is not None
                          else (np.zeros(0, np.int64),) * 2)
                e = np.concatenate([e1 // 6, e2 // 4])
                rank = np.concatenate([np.nonzero(thaw)[0][g1],
                                       np.nonzero(~thaw)[0][g2]])
                val = np.concatenate([np.ones(len(e1), dtype=bool),
                                      np.zeros(len(e2), dtype=bool)])
                if not (val != S[e]).any():
                    break
                order = np.lexsort((rank, e))
                last = np.r_[e[order][1:] != e[order][:-1], True]
                S[e[order][last]] = val[order][last]
            # veto fixpoint: an S element may not refine while it holds a
            # hanging node whose coarse edge is frozen or has an owner
            # outside S (the closure's iteration cap can leave one);
            # vetoes only shrink S, so this terminates
            while S.any():
                out = (edges.count(hkeys, ~S) > 0) | hfrozen
                if not out.any():
                    break
                bad = S & np.isin(conn, hang[out]).any(axis=1)
                if not bad.any():
                    break
                S[bad] = False
        if not S.any():
            return None

        F = np.nonzero(S)[0]
        U = np.nonzero(~S)[0]
        cf = conn[F]  # (Ef, 4)
        Ef = cf.shape[0]

        # ---- mid-edge nodes (reuse existing hanging nodes) ------------
        edges = cf[:, _TET_EDGES].reshape(Ef * 6, 2)
        uniq, inv = _unique_rows(edges)  # uniq sorted (Ue, 2)
        ukeys = _pair_keys(uniq, N)
        hkeys = _pair_keys(list(self.hanging), N)
        hvals = np.fromiter(self.hanging.values(), dtype=np.int64,
                            count=len(self.hanging))
        mid_of = np.empty(len(uniq), dtype=np.int64)
        reuse = np.isin(ukeys, hkeys)
        if reuse.any():
            order = np.argsort(hkeys)
            mid_of[reuse] = hvals[order][np.searchsorted(hkeys[order],
                                                         ukeys[reuse])]
        new_edges = uniq[~reuse]  # edges that get a NEW node this pass
        mid_of[~reuse] = N + np.arange(len(new_edges))
        coords = np.concatenate(
            [mesh.coords, mesh.coords[new_edges].mean(axis=1)], axis=0)
        mid_ids = mid_of[inv].reshape(Ef, 6)

        # ---- 1:8 split (same pattern as mesh/refine._refine_tet) ------
        v = cf
        m01, m02, m03, m12, m13, m23 = (mid_ids[:, i] for i in range(6))
        corner = [
            np.stack([v[:, 0], m01, m02, m03], axis=1),
            np.stack([m01, v[:, 1], m12, m13], axis=1),
            np.stack([m02, m12, v[:, 2], m23], axis=1),
            np.stack([m03, m13, m23, v[:, 3]], axis=1),
        ]

        def d2(a, b):
            return ((coords[a] - coords[b]) ** 2).sum(axis=1)

        diags = np.stack([d2(m01, m23), d2(m02, m13), d2(m03, m12)],
                         axis=1)
        choice = np.argmin(diags, axis=1)
        octa_sets = []
        for p, q, eq in (
            (m01, m23, (m02, m03, m13, m12)),
            (m02, m13, (m01, m03, m23, m12)),
            (m03, m12, (m01, m02, m23, m13)),
        ):
            tets = [np.stack([p, q, eq[i], eq[(i + 1) % 4]], axis=1)
                    for i in range(4)]
            octa_sets.append(np.stack(tets, axis=1))
        octa = np.select(
            [choice[:, None, None] == c for c in range(3)], octa_sets)
        children = np.concatenate(
            [np.stack(corner, axis=1), octa], axis=1).reshape(Ef * 8, 4)
        X = coords[children]
        vol6 = np.einsum(
            "ei,ei->e",
            np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]),
            X[:, 3] - X[:, 0])
        flip = vol6 < 0
        children[flip, 2], children[flip, 3] = (
            children[flip, 3].copy(), children[flip, 2].copy())

        new_conn = np.concatenate([conn[U], children], axis=0)
        subdomain = np.concatenate(
            [mesh.subdomain_id[U], np.repeat(mesh.subdomain_id[F], 8)])
        elem_map = np.concatenate([U, np.repeat(F, 8)]).astype(np.int64)

        # ---- refinement forest (enables coarsening) --------------------
        # each flagged parent becomes a sibling-group record; its 8
        # children carry the fresh group id at level+1 (node ids are
        # stable under refine, so stored records stay valid)
        bf_by_owner: Dict[int, List[Tuple[Tuple[int, int, int], int]]] = {}
        bfaces0 = (mesh.boundary_faces
                   if mesh.boundary_faces is not None else [])
        bids0 = mesh.boundary_id if mesh.boundary_id is not None else []
        belems0 = mesh.boundary_elem if mesh.boundary_elem is not None else []
        for face, bid, owner in zip(bfaces0, bids0, belems0):
            if S[owner]:
                bf_by_owner.setdefault(int(owner), []).append(
                    (tuple(int(x) for x in sorted(face)), int(bid)))
        next_g = (max(self.groups) + 1) if self.groups else 0
        new_groups = dict(self.groups)
        gids = np.arange(next_g, next_g + Ef, dtype=np.int64)
        for j, e in enumerate(F):
            new_groups[int(gids[j])] = _Group(
                parent_conn=conn[e].copy(), mids=mid_ids[j].copy(),
                subdomain=int(mesh.subdomain_id[e]),
                parent_group=int(self.elem_group[e]),
                parent_level=int(self.elem_level[e]),
                bfaces=bf_by_owner.get(int(e), []))
        elem_group_new = np.concatenate(
            [self.elem_group[U], np.repeat(gids, 8)])
        elem_level_new = np.concatenate(
            [self.elem_level[U], np.repeat(self.elem_level[F] + 1, 8)])

        # ---- hanging-node bookkeeping ---------------------------------
        # a mid-edge node is hanging iff its edge still belongs to an
        # unsplit element; otherwise (all owners split) it is free.
        # Constraints untouched by this pass persist as long as their
        # coarse owners remain unsplit
        unsplit = np.union1d(_edge_keys(conn[U], N),
                             self._frozen_keys(N))
        new_hanging: Dict[Tuple[int, int], int] = {}
        for i in np.nonzero(np.isin(ukeys, unsplit))[0]:
            new_hanging[(int(uniq[i, 0]), int(uniq[i, 1]))] = int(mid_of[i])
        keep = np.isin(hkeys, unsplit) & ~np.isin(hkeys, ukeys)
        for key, h, k in zip(self.hanging, hvals.tolist(), keep):
            if k:
                new_hanging[key] = h

        # ---- boundary propagation -------------------------------------
        mid_lookup = {}
        for i, (a, b) in enumerate(map(tuple, uniq)):
            mid_lookup[(int(a), int(b))] = int(mid_of[i])
            mid_lookup[(int(b), int(a))] = int(mid_of[i])
        keys, ids = [], []
        split = S
        bfaces = mesh.boundary_faces if mesh.boundary_faces is not None else []
        bids = mesh.boundary_id if mesh.boundary_id is not None else []
        belems = mesh.boundary_elem if mesh.boundary_elem is not None else []
        for face, bid, owner in zip(bfaces, bids, belems):
            if split[owner]:
                for ch in _tri_children(
                        tuple(int(x) for x in face), mid_lookup):
                    keys.append(sorted(ch))
                    ids.append(int(bid))
            else:
                keys.append(sorted(int(x) for x in face))
                ids.append(int(bid))
        new_mesh = _propagate_boundary(
            mesh, new_conn.astype(np.int32), "TET4", coords, subdomain,
            np.asarray(keys, dtype=np.int64),
            np.asarray(ids, dtype=np.int32))

        def prolong(u):
            u = np.asarray(u)
            if not len(new_edges):
                return u.copy()
            return np.concatenate([u, u[new_edges].mean(axis=1)], axis=0)

        return ConstrainedAdaptResult(
            ConstrainedMesh(new_mesh, new_hanging, new_groups,
                            elem_group_new, elem_level_new,
                            self.frozen_edges, self.pinned_nodes),
            prolong, elem_map)

    # ------------------------------------------------------------------
    def coarsen(self, flags: np.ndarray):
        """Collapse sibling groups whose 8 children are all active and
        all flagged back to their recorded parents (libMesh
        `_coarsen_elements`); returns (ConstrainedMesh, kept_nodes,
        transfer_elemental) or None when nothing collapses.  Collapses
        that would strand a finer neighbor's hanging node or chain
        constraints are vetoed (the level-one rule)."""
        mesh = self.mesh
        conn = mesh.connectivity.astype(np.int64)
        cf = np.asarray(flags, dtype=bool)
        if not self.groups or not cf.any():
            return None
        eg = self.elem_group
        N = mesh.n_nodes
        # candidate groups: exactly 8 active members (a refined child
        # leaves the active set, so count==8 <=> all children active),
        # every member flagged
        live = eg >= 0
        n_groups = int(eg.max()) + 1 if live.any() else 0
        members = np.bincount(eg[live], minlength=n_groups)
        flagged = np.bincount(eg[live & cf], minlength=n_groups)
        C = set(np.nonzero((members == 8) & (flagged == 8))[0].tolist())
        if not C:
            return None

        edges = _EdgeTable(conn, N)
        while C:
            C_arr = np.fromiter(C, dtype=np.int64)
            removed = np.isin(eg, C_arr)
            parents = np.stack(
                [self.groups[g].parent_conn for g in sorted(C)])
            conn_act = np.concatenate([conn[~removed], parents], axis=0)
            referenced = np.zeros(N, dtype=bool)
            referenced[conn_act.reshape(-1)] = True
            active_edges = np.union1d(_edge_keys(conn_act, N),
                                      self._frozen_keys(N))

            # candidate hanging set + the group(s) whose collapse each
            # entry depends on (for targeted vetoes)
            entries: Dict[Tuple[int, int], Tuple[int, set]] = {}
            for key, h in self.hanging.items():
                if referenced[h]:
                    entries[key] = (int(h), set())
            for g in sorted(C):
                gr = self.groups[g]
                pe = np.sort(gr.parent_conn[_TET_EDGES], axis=1)
                for (a, b), m in zip(pe.tolist(), gr.mids.tolist()):
                    if referenced[m]:
                        entries[(a, b)] = (m, {g})

            veto: set = set()
            new_hanging: Dict[Tuple[int, int], int] = {}
            contributed: Dict[Tuple[int, int], set] = {}
            ekeys = _pair_keys(list(entries), N)
            for (key, (h, deps)), alive in zip(
                    entries.items(), np.isin(ekeys, active_edges)):
                if alive:
                    new_hanging[key] = h
                    contributed[key] = deps
                elif not deps:
                    # a pre-existing constraint lost every coarse owner:
                    # its unsplit owners were children of collapsing
                    # groups — stranding h against a vanished edge breaks
                    # the level-one rule; veto those groups
                    owners = edges.owners(_pair_keys([key], N))
                    veto.update(int(x) for x in eg[owners]
                                if x >= 0 and int(x) in C)
            # chained constraints: a hanging node as a master endpoint
            hvals = set(new_hanging.values())
            for (a, b), h in new_hanging.items():
                if a in hvals or b in hvals:
                    veto.update(contributed[(a, b)])
                    for k2, h2 in new_hanging.items():
                        if h2 in (a, b):
                            veto.update(contributed[k2])
            veto &= C
            if not veto:
                break
            C -= veto
        if not C:
            return None

        # ---- build the coarsened mesh ----------------------------------
        C_list = sorted(C)
        C_arr = np.fromiter(C_list, dtype=np.int64)
        removed = np.isin(eg, C_arr)
        survivors = np.nonzero(~removed)[0]
        parents = np.stack([self.groups[g].parent_conn for g in C_list])
        conn_new = np.concatenate([conn[survivors], parents], axis=0)
        subdomain = np.concatenate([
            mesh.subdomain_id[survivors],
            np.asarray([self.groups[g].subdomain for g in C_list],
                       dtype=mesh.subdomain_id.dtype)])
        eg_new = np.concatenate([
            eg[survivors],
            np.asarray([self.groups[g].parent_group for g in C_list],
                       dtype=np.int64)])
        lvl_new = np.concatenate([
            self.elem_level[survivors],
            np.asarray([self.groups[g].parent_level for g in C_list],
                       dtype=np.int64)])

        # orphaned mid nodes drop out; renumber the survivors (pinned
        # nodes stay: MixedConstrained remaps its other blocks through
        # `kept`)
        kept = np.unique(conn_new)
        if self.pinned_nodes is not None:
            kept = np.union1d(kept, self.pinned_nodes)
        old2new = np.full(mesh.n_nodes, -1, dtype=np.int64)
        old2new[kept] = np.arange(len(kept))
        conn_new = old2new[conn_new]
        coords = mesh.coords[kept]
        hang_new = {
            (int(old2new[a]), int(old2new[b])): int(old2new[h])
            for (a, b), h in new_hanging.items()}

        # forest: drop collapsed groups, renumber the rest (their nodes
        # are corners/mids of still-active descendants, hence kept)
        groups_new: Dict[int, _Group] = {}
        for g, gr in self.groups.items():
            if g in C:
                continue
            groups_new[g] = _Group(
                parent_conn=old2new[gr.parent_conn],
                mids=old2new[gr.mids], subdomain=gr.subdomain,
                parent_group=gr.parent_group,
                parent_level=gr.parent_level,
                bfaces=[(tuple(int(old2new[x]) for x in f), bid)
                        for f, bid in gr.bfaces])

        # boundary ids: surviving elements keep their faces, restored
        # parents bring their recorded faces
        keys, ids = [], []
        bfaces0 = (mesh.boundary_faces
                   if mesh.boundary_faces is not None else [])
        bids0 = mesh.boundary_id if mesh.boundary_id is not None else []
        belems0 = mesh.boundary_elem if mesh.boundary_elem is not None else []
        for face, bid, owner in zip(bfaces0, bids0, belems0):
            if not removed[owner]:
                keys.append(sorted(int(old2new[x]) for x in face))
                ids.append(int(bid))
        for g in C_list:
            for f, bid in self.groups[g].bfaces:
                keys.append(sorted(int(old2new[x]) for x in f))
                ids.append(int(bid))
        new_mesh = _propagate_boundary(
            mesh, conn_new.astype(np.int32), "TET4", coords, subdomain,
            np.asarray(keys, dtype=np.int64),
            np.asarray(ids, dtype=np.int32))

        # elemental transfer: volume-weighted mean of the 8 children
        # (the P0 L2 projection libMesh's coarsening performs)
        X = mesh.coords[conn]
        vol = np.abs(np.einsum(
            "ei,ei->e",
            np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]),
            X[:, 3] - X[:, 0]))
        by_group = np.argsort(eg, kind="stable")
        starts = np.searchsorted(eg[by_group], C_arr)
        members_of = {g: by_group[i:i + 8] for g, i in zip(C_list, starts)}

        def transfer_elemental(vals):
            vals = np.asarray(vals)
            out_sur = vals[survivors]
            rows = []
            for g in C_list:
                m = members_of[g]
                w = vol[m] / vol[m].sum()
                rows.append(np.tensordot(w, vals[m], axes=(0, 0)))
            return np.concatenate(
                [out_sur, np.stack(rows)], axis=0
            ).astype(vals.dtype) if rows else out_sur

        remap = lambda a: None if a is None else old2new[a]
        return (ConstrainedMesh(new_mesh, hang_new, groups_new,
                                eg_new, lvl_new,
                                remap(self.frozen_edges),
                                remap(self.pinned_nodes)),
                kept, transfer_elemental)

    # ------------------------------------------------------------------
    def refine_and_coarsen(self, refine_flags: np.ndarray,
                           coarsen_flags: np.ndarray,
                           max_level: Optional[int] = None):
        """libMesh `refine_and_coarsen_elements` order: coarsen first,
        then refine, with composed nodal/elemental transfers.  Returns
        ConstrainedRACResult or None when the mesh is unchanged."""
        cm = self
        kept = None
        transfer_e1 = None
        cres = cm.coarsen(np.asarray(coarsen_flags, dtype=bool)
                          & ~np.asarray(refine_flags, dtype=bool))
        rflags = np.asarray(refine_flags, dtype=bool)
        if cres is not None:
            cm, kept, transfer_e1 = cres
            # remap refine flags onto the coarsened element list:
            # survivors keep theirs, restored parents are not refined
            # in the same pass (their children were coarsen-flagged)
            sur = np.nonzero(~np.isin(self.elem_group,
                                      np.fromiter(
                                          (g for g in self.groups
                                           if g not in cm.groups),
                                          dtype=np.int64)))[0]
            nf = np.zeros(cm.mesh.n_elems, dtype=bool)
            nf[: len(sur)] = rflags[sur]
            rflags = nf
        rres = cm.refine(rflags, max_level=max_level)
        if rres is None and cres is None:
            return None

        def prolong(u):
            u = np.asarray(u)
            if kept is not None:
                u = u[kept]
            return rres.prolong(u) if rres is not None else u.copy()

        def transfer_elemental(vals):
            vals = np.asarray(vals)
            if transfer_e1 is not None:
                vals = transfer_e1(vals)
            if rres is not None:
                vals = vals[rres.elem_map]
            return vals

        final = rres.constrained if rres is not None else cm
        return ConstrainedRACResult(final, prolong, transfer_elemental,
                                    kept_nodes=kept)
