"""Selective conforming AMR on TET4: longest-edge bisection with closure,
and coarsening (host NumPy copy of rdcfes_tpu.mesh.adapt, the same
arrays).

The "bisection" strategy of the PIHNA driver, the reference package's
deviation from libMesh's selective 1:8: flagged tets are bisected along
their longest edge (Rivara), with the conformity closure, so no
hanging-node constraints are needed.  One libMesh `max_level` unit is 3
bisection levels (2^3 = 8 children).

Coarsening undoes bisections: a sibling pair created by a split merges
back when both children are coarsen-flagged, neither was refined since,
and every element sharing their midpoint node merges too (the midpoint
must become unreferenced).

Host-side topology work only; the device system is rebuilt on the new
mesh afterwards.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from .core import Mesh

_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


class AdaptResult(NamedTuple):
    """Outcome of one refine/coarsen operation.

    adaptive            : the new AdaptiveMesh
    prolong(u)          : nodal (N_old, ...) -> (N_new, ...) P1 transfer
    elem_map            : (E_new,) source element index per new element
                          (restrict elemental fields as vals[elem_map])
    """

    adaptive: "AdaptiveMesh"
    prolong: Callable[[np.ndarray], np.ndarray]
    elem_map: np.ndarray


@dataclass
class AdaptiveMesh:
    """A TET4 mesh plus the bisection history needed to refine AND coarsen.

    level    : (E,) bisection depth per element (0 = original)
    sibling  : (E,) element index of the bisection sibling, -1 when the
               element is original or its sibling was since modified
    midpoint : (E,) node id of the parent's split-edge midpoint, -1 likewise
    """

    mesh: Mesh
    level: np.ndarray = field(default=None)
    sibling: np.ndarray = field(default=None)
    midpoint: np.ndarray = field(default=None)

    def __post_init__(self):
        E = self.mesh.n_elems
        if self.level is None:
            self.level = np.zeros(E, dtype=np.int32)
        if self.sibling is None:
            self.sibling = np.full(E, -1, dtype=np.int64)
        if self.midpoint is None:
            self.midpoint = np.full(E, -1, dtype=np.int64)

    # ------------------------------------------------------------------
    def refine(self, flags: np.ndarray, max_level: int = 3) -> Optional[AdaptResult]:
        """Bisect the flagged elements (+ conformity closure).

        max_level is in libMesh 1:8 units: elements at bisection depth
        >= 3 * max_level are not seeded (closure may still deepen a
        neighbor by one, as libMesh's refinement smoothing also does).
        Returns None when nothing refines."""
        mesh = self.mesh
        assert mesh.elem_type == "TET4", "selective AMR supports TET4"
        conn = mesh.connectivity.astype(np.int64).copy()
        coords = mesh.coords
        E = conn.shape[0]
        flags = np.asarray(flags, dtype=bool)
        seed = flags & (self.level < 3 * max_level)
        if not seed.any():
            return None

        # --- closure: propagate longest-edge marks to a conforming set ----
        def edge_key(a, b):
            return (min(int(a), int(b)), max(int(a), int(b)))

        elem_edges = conn[:, _TET_EDGES]  # (E, 6, 2)
        lengths = ((coords[elem_edges[..., 0]]
                    - coords[elem_edges[..., 1]]) ** 2).sum(axis=2)
        # deterministic longest-edge choice: (length, min_id, max_id) key so
        # two elements sharing their longest edge agree on the pick
        lo = np.minimum(elem_edges[..., 0], elem_edges[..., 1])
        hi = np.maximum(elem_edges[..., 0], elem_edges[..., 1])
        tie = (lo * 7919 + hi) % 1000003
        keyed = lengths + 1e-12 * lengths.max() * (tie / 1000003.0)
        pick = np.argmax(keyed, axis=1)

        # propagate: any element with a split edge must bisect its OWN
        # longest edge too (Rivara); the fixpoint is the reference's
        # element-by-element sweep's, taken a whole sweep at a time
        N = mesh.n_nodes
        ekeys = lo * N + hi  # (E, 6) edge keys
        pick_keys = ekeys[np.arange(E), pick]
        active = seed.copy()
        split = np.unique(pick_keys[active])
        while True:
            active |= np.isin(ekeys, split).any(axis=1)
            grown = np.union1d(split, pick_keys[active])
            if len(grown) == len(split):
                break
            split = grown

        # --- assign midpoint node ids ------------------------------------
        split_edges = [(int(k // N), int(k % N)) for k in split]
        mid_of = {ek: N + i for i, ek in enumerate(split_edges)}
        new_coords = [coords]
        new_node_parents = np.array(split_edges, dtype=np.int64).reshape(-1, 2)
        if len(split_edges):
            ends = np.asarray(split_edges, dtype=np.int64)
            new_coords.append(coords[ends].mean(axis=1))
        coords_new = np.concatenate(new_coords, axis=0)

        # --- bisect: every element must end with NO split edges -----------
        # work entries: (conn4, level, src_elem, subdomain, sibling, midpoint)
        out_conn, out_level, out_src = [], [], []
        out_sib, out_mid = [], []
        node_parent_chain = []  # extra midpoints created during cascades

        def elem_split_edges(c4):
            found = []
            for (i, j) in _TET_EDGES:
                k = edge_key(c4[i], c4[j])
                m = mid_of.get(k)
                if m is not None:
                    found.append((k, m, int(c4[i]), int(c4[j])))
            return found

        def bisect(c4, lvl, src):
            """Recursively bisect until no split edges remain; returns list
            of (conn4, level, sibling_marker, midpoint) — sibling linkage is
            fixed up after emission."""
            se = elem_split_edges(c4)
            if not se:
                return [(c4, lvl, -1, -1)]
            # split by the longest split edge (deterministic key as above)
            best, best_key = None, None
            for (k, m, a, b) in se:
                L = ((coords_new[a] - coords_new[b]) ** 2).sum()
                kk = (L, -k[0], -k[1])
                if best_key is None or kk > best_key:
                    best_key, best = kk, (k, m, a, b)
            k, m, a, b = best
            c0 = [m if int(x) == a else int(x) for x in c4]
            c1 = [m if int(x) == b else int(x) for x in c4]
            left = bisect(np.asarray(c0), lvl + 1, src)
            right = bisect(np.asarray(c1), lvl + 1, src)
            if len(left) == 1 and len(right) == 1:
                # direct sibling pair: record midpoint for coarsening
                (lc, ll, _, _), (rc, rl, _, _) = left[0], right[0]
                return [(lc, ll, -2, m), (rc, rl, -3, m)]
            return left + right

        for e in range(E):
            if not active[e]:
                out_conn.append(conn[e])
                out_level.append(int(self.level[e]))
                out_src.append(e)
                out_sib.append(-1)   # old sibling links die on rebuild: the
                out_mid.append(-1)   # pairing below re-establishes fresh ones
                continue
            pieces = bisect(conn[e], int(self.level[e]), e)
            base = len(out_conn)
            for i, (c4, lvl, sib_marker, m) in enumerate(pieces):
                out_conn.append(np.asarray(c4, dtype=np.int64))
                out_level.append(lvl)
                out_src.append(e)
                if sib_marker == -2:
                    out_sib.append(base + i + 1)
                elif sib_marker == -3:
                    out_sib.append(base + i - 1)
                else:
                    out_sib.append(-1)
                out_mid.append(m)

        conn_new = np.stack(out_conn).astype(np.int64)
        # fix orientation (positive volume)
        X = coords_new[conn_new]
        vol6 = np.einsum("ei,ei->e",
                         np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]),
                         X[:, 3] - X[:, 0])
        flip = vol6 < 0
        conn_new[flip, 2], conn_new[flip, 3] = (
            conn_new[flip, 3].copy(), conn_new[flip, 2].copy())

        elem_map = np.asarray(out_src, dtype=np.int64)
        sub_new = mesh.subdomain_id[elem_map]
        new_mesh = _rebuild_mesh(mesh, coords_new, conn_new, sub_new)

        ends = new_node_parents

        def prolong(u):
            u = np.asarray(u)
            if not len(ends):
                return u
            return np.concatenate([u, u[ends].mean(axis=1)], axis=0)

        adaptive = AdaptiveMesh(
            new_mesh,
            level=np.asarray(out_level, dtype=np.int32),
            sibling=np.asarray(out_sib, dtype=np.int64),
            midpoint=np.asarray(out_mid, dtype=np.int64),
        )
        return AdaptResult(adaptive, prolong, elem_map)

    # ------------------------------------------------------------------
    def coarsen(self, flags: np.ndarray) -> Optional[AdaptResult]:
        """Merge coarsen-flagged sibling pairs whose midpoint becomes fully
        unreferenced.  Returns None when nothing coarsens."""
        mesh = self.mesh
        conn = mesh.connectivity.astype(np.int64)
        E = conn.shape[0]
        flags = np.asarray(flags, dtype=bool)

        # candidate pairs: both siblings flagged, mutual links intact
        sib = self.sibling
        cand = (flags & (sib >= 0))
        cand &= np.array([
            bool(cand[s]) and sib[s] == e if (s := int(sib[e])) >= 0 else False
            for e in range(E)
        ]) if E else cand
        if not cand.any():
            return None

        # a midpoint node is removable iff EVERY element referencing it is a
        # candidate whose pair-midpoint is that node
        ref_count = np.zeros(mesh.n_nodes, dtype=np.int64)
        np.add.at(ref_count, conn.reshape(-1), 1)
        cand_count = np.zeros(mesh.n_nodes, dtype=np.int64)
        for e in np.nonzero(cand)[0]:
            m = int(self.midpoint[e])
            # each candidate element references its midpoint exactly once
            cand_count[m] += 1
        removable = (cand_count > 0) & (cand_count == ref_count)
        if not removable.any():
            return None

        merged = np.zeros(E, dtype=bool)
        out_conn, out_level, out_src = [], [], []
        out_sib, out_mid = [], []
        for e in range(E):
            if merged[e]:
                continue
            m = int(self.midpoint[e])
            s = int(self.sibling[e])
            if cand[e] and m >= 0 and removable[m] and s >= 0 and not merged[s]:
                c0, c1 = conn[e], conn[s]
                # parent = (c0 union c1) minus the midpoint
                parent = np.concatenate([c0, c1])
                parent = np.unique(parent[parent != m])
                assert len(parent) == 4, "sibling merge must yield a tet"
                # orient: keep c0's ordering with m replaced by the vertex
                # unique to c1
                other = [x for x in c1 if x not in c0][0]
                newc = np.where(c0 == m, other, c0)
                merged[e] = merged[s] = True
                out_conn.append(newc)
                out_level.append(int(self.level[e]) - 1)
                out_src.append(e)
                out_sib.append(-1)   # parent linkage beyond one level is
                out_mid.append(-1)   # not tracked (merge again only after
                continue             # a fresh refine/coarsen cycle)
            out_conn.append(conn[e])
            out_level.append(int(self.level[e]))
            out_src.append(e)
            out_sib.append(int(self.sibling[e]))
            out_mid.append(int(self.midpoint[e]))
            merged[e] = True

        conn_new = np.stack(out_conn)
        # drop now-unreferenced nodes, renumber
        used = np.zeros(mesh.n_nodes, dtype=bool)
        used[conn_new.reshape(-1)] = True
        new_id = np.cumsum(used) - 1
        coords_new = mesh.coords[used]
        conn_new = new_id[conn_new]
        elem_map = np.asarray(out_src, dtype=np.int64)
        sub_new = mesh.subdomain_id[elem_map]
        # remap stale sibling element indices (old ids -> new ids)
        old2new = np.full(E, -1, dtype=np.int64)
        for new_e, src in enumerate(out_src):
            old2new[src] = new_e
        sib_arr = np.asarray(out_sib, dtype=np.int64)
        mid_arr = np.asarray(out_mid, dtype=np.int64)
        for i in range(len(sib_arr)):
            s = sib_arr[i]
            if s >= 0:
                ns = old2new[s]
                sib_arr[i] = ns if ns >= 0 else -1
                if ns < 0:
                    mid_arr[i] = -1
        # sibling links must be mutual after renumbering
        for i in range(len(sib_arr)):
            s = sib_arr[i]
            if s >= 0 and (s >= len(sib_arr) or sib_arr[s] != i):
                sib_arr[i] = -1
                mid_arr[i] = -1
        # remap midpoint node ids
        for i in range(len(mid_arr)):
            if mid_arr[i] >= 0:
                mid_arr[i] = new_id[mid_arr[i]] if used[mid_arr[i]] else -1
                if mid_arr[i] < 0:
                    sib_arr[i] = -1

        new_mesh = _rebuild_mesh(mesh, coords_new, conn_new.astype(np.int64),
                                 sub_new)
        keep = used

        def prolong(u):
            """Coarsening transfer = plain selection of surviving nodes."""
            return np.asarray(u)[keep]

        adaptive = AdaptiveMesh(
            new_mesh, level=np.asarray(out_level, dtype=np.int32),
            sibling=sib_arr, midpoint=mid_arr,
        )
        return AdaptResult(adaptive, prolong, elem_map)

    # ------------------------------------------------------------------
    def refine_and_coarsen(self, refine_flags: np.ndarray,
                           coarsen_flags: np.ndarray,
                           max_level: int = 3) -> Optional[AdaptResult]:
        """`MeshRefinement::refine_and_coarsen_elements` analogue: coarsen
        first (on the current topology), then refine; composes transfers."""
        r1 = self.coarsen(coarsen_flags)
        cur = r1.adaptive if r1 else self
        rf = np.asarray(refine_flags, dtype=bool)
        if r1 is not None:
            # refine flags move to the coarsened topology: a merged pair's
            # parent inherits refine=False (it was just coarsened)
            moved = np.zeros(cur.mesh.n_elems, dtype=bool)
            for new_e, src in enumerate(r1.elem_map):
                moved[new_e] = rf[src] and cur.level[new_e] >= self.level[src]
            rf = moved
        r2 = cur.refine(rf, max_level=max_level)
        if r1 is None and r2 is None:
            return None
        if r2 is None:
            return r1
        if r1 is None:
            return r2
        p1, p2 = r1.prolong, r2.prolong
        emap = r1.elem_map[r2.elem_map]
        return AdaptResult(r2.adaptive, lambda u: p2(p1(u)), emap)


def _rebuild_mesh(old: Mesh, coords, conn, subdomain) -> Mesh:
    """Child mesh + boundary-id propagation by face-key containment: a new
    boundary face lies inside exactly one old boundary face (bisection never
    moves the boundary), so match via its vertices' membership."""
    m = Mesh(coords, conn.astype(np.int32), "TET4",
             np.asarray(subdomain, dtype=old.subdomain_id.dtype))
    if len(old.boundary_faces) == 0 or len(m.boundary_faces) == 0:
        return m
    # map every old boundary NODE to its face ids, then a new face takes the
    # id shared by all of its (original-or-midpoint) vertices' parents.
    # Midpoints: their parent nodes are recoverable geometrically — instead
    # of tracking, classify by coordinates: a new face's centroid lies on
    # the old face's plane within its triangle.  Cheap approach: build a
    # dict from old boundary faces to ids and classify each new face by
    # nearest old face among those containing its centroid.
    from scipy.spatial import cKDTree

    old_centers = old.coords[old.boundary_faces].mean(axis=1)
    tree = cKDTree(old_centers)
    new_centers = m.coords[m.boundary_faces].mean(axis=1)
    # candidate = nearest few old faces; verify by plane + barycentric test
    k = min(8, len(old_centers))
    _, idxs = tree.query(new_centers, k=k)
    if k == 1:
        idxs = idxs[:, None]
    ids = np.zeros(len(m.boundary_faces), dtype=np.int32)
    A = old.coords[old.boundary_faces[:, 0]]
    B = old.coords[old.boundary_faces[:, 1]]
    C = old.coords[old.boundary_faces[:, 2]]
    for f in range(len(m.boundary_faces)):
        p = new_centers[f]
        assigned = False
        for j in idxs[f]:
            a, b, c = A[j], B[j], C[j]
            n = np.cross(b - a, c - a)
            nn = np.linalg.norm(n)
            if nn == 0:
                continue
            if abs(np.dot(p - a, n / nn)) > 1e-6 * np.sqrt(nn):
                continue
            # barycentric containment
            v0, v1, v2 = c - a, b - a, p - a
            d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
            d20, d21 = v2 @ v0, v2 @ v1
            den = d00 * d11 - d01 * d01
            if den == 0:
                continue
            u = (d11 * d20 - d01 * d21) / den
            v = (d00 * d21 - d01 * d20) / den
            if u >= -1e-9 and v >= -1e-9 and u + v <= 1 + 1e-9:
                ids[f] = old.boundary_id[j]
                assigned = True
                break
        if not assigned:
            ids[f] = 0
    m.boundary_id = ids
    return m


class AdaptOutcome(NamedTuple):
    """Driver-facing result, interface-compatible with refine.Refinement."""

    mesh: Mesh
    adaptive: AdaptiveMesh
    prolong: Callable[[np.ndarray], np.ndarray]
    restrict_elemental: Callable[[np.ndarray], np.ndarray]


def adapt_flagged(adaptive: AdaptiveMesh, refine_flags: np.ndarray,
                  coarsen_flags: np.ndarray, max_level: int = 3
                  ) -> Optional[AdaptOutcome]:
    """Selective refine-and-coarsen for driver AMR blocks: the TET4
    bisection forest, or an adapt_ext.Tet10Adaptive (its skeleton's).

    Returns None when neither operation changes the mesh."""
    r = adaptive.refine_and_coarsen(refine_flags, coarsen_flags,
                                    max_level=max_level)
    if r is None:
        return None
    emap = r.elem_map

    def restrict_elemental(vals):
        return np.asarray(vals)[emap]

    return AdaptOutcome(r.adaptive.mesh, r.adaptive, r.prolong,
                        restrict_elemental)
