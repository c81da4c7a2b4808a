"""The multi-device transient system: node-partitioned Krylov with a halo
exchange (the port of rdcfes_tpu/parallel/halo.py on fixed meshes; the
reference app's libMesh ghost sync and PETSc VecScatter under every
solve, src/pihna.C:80).

Layout, built once on the host (HaloPlan, the reference's tables):

  * elements are split into D shards by recursive coordinate bisection of
    their centroids (native.partition_rcb) and renumbered shard by shard;
  * each node is owned by the shard whose elements touch it most (the
    lowest shard on a tie); nodes are renumbered owner by owner, so each
    shard holds a (V, No_max) slab of the solution;
  * a shard's elements read its owned nodes plus a few ghosts on its
    boundary, grouped by their owner's offset d = (dst - src) mod D: one
    exchange per offset moves the boundary values (VecScatter forward),
    the reverse one returns the boundary partial sums to their owners
    after every element apply (VecScatter reverse, ADD_VALUES);
  * dot products are local sums plus a sum over the shards.

A MixedMesh gets one node-side plan over the K_max-padded concatenation
of its blocks (build_mixed_plan, the reference's): padding repeats each
element's corner 0, which adds no node to any shard, and the element
tables are then split back per block.  A shard may hold no element of a
block, or none at all.

The reference runs the shards as one shard_map program over D devices.
Here they run in one process, one after the other, through a ShardGroup:
a list of D torch devices (repeats allowed).  An exchange is a `.to()`
of each sender's buffer onto its receiver's device, free when the two
are the same device; the sum over shards adds the per-shard scalars in
shard order.  No torch.distributed: NCCL refuses two ranks on one GPU,
and a deck that asks for 4 shards on a one-card machine runs them all on
that card, as `mpiexec -n 4` ranks share a node's card.  `shard_devices`
is the placement rule: the CPU gives every shard the CPU; a CUDA device
gives shard s the card (index + s) mod torch.cuda.device_count(); None is
the card (utils.device.cuda_device: never the CPU).

Each shard's element work is the single-device system's ElementBlock, one
per element type the shard holds, on the shard's local connectivity into
its (V, No_max + Gtot) slab: on TET4 and TRI3 K1 (gather +
interpolation), K2 (right-hand side) and K3 (f64 apply) in every matvec;
on the other types K8 and K6.  One K4 launch restricts the corner values
of the shard's blocks, concatenated in block order, onto the local slab
(as MixedTransientRDCSystem does on one device; the reference sums one
restriction per block), and K4 again sums the returned ghost partials
onto their owners through rev_gather.  A block a shard does not hold
launches nothing there.  The dense path (`physics=` without blocks)
applies each block's element matrices by one batched product.  With
hanging-node constraints (TET4 1:8, or a MixedMesh's TET4 block against
the others) the plan's closure puts both masters of a visible hanging
node in the shard, so C and C^T act shard-locally
(fem/constraints.Constraints on local slots) before the reverse add.

The step is the reference's halo step, not the single-device system's:
f64 left-preconditioned BiCGStab from x0 = 2u - u_old, block-Jacobi
rebuilt every step (empty rows get an identity block), the reference's
breakdown freezes and stopping rule.  Each shard's elements are kept
unpadded (the reference pads them to Eb for its SPMD program; the tables
of HaloPlan keep that padding, and the system drops it).

The moving mesh (`moving_mesh=True`, `coords=` in `step` and
`run_steps`; the coupled HCC driver's transport on the deformed
configuration): the positions (N, 3) are scattered to (3, No_max) slabs
(`scatter_coords`, cached by the identity of the array it was given),
ghost-filled, and each shard builds its blocks' Geometry from its own
(Nloc, 3) slab through its local connectivity, so a shard holds
O(N/D + boundary) positions and reads the same bits as one device.
`step(coords=)` builds it every call, `run_steps(coords=)` once per call.

HaloExchange (ghost_fill, reverse_add, scatter_nodal, gather) is shared
with the solid's halo Newton (parallel/solid_halo.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import (Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..fem.assembly import block_node_gather
from ..fem.constraints import Constraints
from ..fem.kernels import KERNEL_OPS, Ops
from ..native import partition_rcb
from ..solvers.krylov import (DEFAULT_MAXITER, DEFAULT_RTOL, _dot,
                              apply_block_jacobi, small_block_inverse)
from ..systems.transient import (_ELEMENT_TYPES, ElementBlock, Geometry,
                                 TransientRDCSystem, clamp_nonnegative)
from ..utils.device import cuda_device


@dataclass
class HaloPlan:
    """Host-built partition and exchange tables of a D-shard halo solve
    (the reference's HaloPlan, field for field; (D, ...) tables stack the
    shards' rows)."""

    D: int
    n_nodes: int
    n_elems: int
    No_max: int                      # padded owned-node count per shard
    Eb: int                          # padded element count per shard
    Gtot: int                        # total ghost slots (sum over deltas)
    deltas: Tuple[int, ...]          # exchange offset classes
    seg_sizes: Tuple[int, ...]       # ghost-segment width per delta
    owned_counts: np.ndarray         # (D,) real owned nodes per shard
    elem_counts: np.ndarray          # (D,) real elements per shard
    node_order: np.ndarray           # new-from-old node permutation (N,)
    node_rank: np.ndarray            # old-from-new inverse (N,)
    node_start: np.ndarray           # (D+1,) owned ranges in renumbered ids
    elem_order: np.ndarray           # new-from-old element permutation (E,)
    conn_local: np.ndarray           # (D, K, Eb) local-slot connectivity
    node_gather: np.ndarray          # (D, C, No_max + Gtot) restriction
    send_idx: List[np.ndarray]       # per delta: (D, S_d) sender local slots
    rev_gather: np.ndarray           # (D, Cr, No_max) reverse-add table
    # hanging-node rows [h, a, b] in LOCAL slots for every h visible on a
    # shard, pad = Nloc; hang_mask zeroes the OWNED hanging slots
    has_cons: bool = False
    cons_all: Optional[np.ndarray] = None    # (D, 3, Hmax)
    hang_mask: Optional[np.ndarray] = None   # (D, No_max)

    @staticmethod
    def build(mesh, D: int,
              constraints: Optional[np.ndarray] = None) -> "HaloPlan":
        """The plan of `mesh` (anything with connectivity (E, K), n_nodes
        and coords) on D shards."""
        conn = np.asarray(mesh.connectivity)
        E, K = conn.shape
        N = mesh.n_nodes

        # ---- element partition: RCB on centroids -------------------------
        centers = mesh.coords[conn].mean(axis=1)
        part = partition_rcb(np.asarray(centers, dtype=np.float64), D)
        elem_order = np.argsort(part, kind="stable")
        e_counts = np.bincount(part, minlength=D)
        Eb = int(e_counts.max()) if E else 1
        e_starts = np.concatenate([[0], np.cumsum(e_counts)])

        # ---- node ownership: majority vote of touching shards ------------
        votes = np.zeros((N, D), dtype=np.int32)
        np.add.at(votes, (conn.reshape(-1), np.repeat(part, K)), 1)
        owner = votes.argmax(axis=1).astype(np.int32)  # tie: lowest shard
        # renumber nodes owner-contiguous (stable keeps original order)
        node_order = np.argsort(owner, kind="stable")
        node_rank = np.empty(N, dtype=np.int64)
        node_rank[node_order] = np.arange(N)
        owned_counts = np.bincount(owner, minlength=D)
        No_max = int(owned_counts.max())
        node_start = np.concatenate([[0], np.cumsum(owned_counts)])

        conn_sorted = node_rank[conn][elem_order]  # renumbered, shard order

        # ---- per-shard ghost sets, grouped by owner -----------------------
        # ghost_by_pair[(src, dst)]: ascending renumbered ids owned by src
        # that dst reads (both sides derive their buffer order from it)
        cons_r = None
        if constraints is not None and len(constraints):
            cons_r = node_rank[np.asarray(constraints, dtype=np.int64)]

        ghost_by_pair: Dict[Tuple[int, int], np.ndarray] = {}
        shard_nodes: List[np.ndarray] = []
        for s in range(D):
            used = np.unique(conn_sorted[e_starts[s]:e_starts[s + 1]])
            if cons_r is not None:
                # constraint closure: wherever a hanging node is visible,
                # its masters a, b are too (one level: masters never hang)
                sel = np.isin(cons_r[:, 0], used)
                if sel.any():
                    used = np.union1d(used, np.unique(cons_r[sel, 1:3]))
            shard_nodes.append(used)
            lo, hi = node_start[s], node_start[s + 1]
            ghosts = used[(used < lo) | (used >= hi)]
            if len(ghosts):
                g_owner = np.searchsorted(node_start, ghosts,
                                          side="right") - 1
                for t in np.unique(g_owner):
                    ghost_by_pair[(int(t), s)] = ghosts[g_owner == t]

        deltas = sorted({(dst - src) % D for (src, dst) in ghost_by_pair})
        seg_sizes = []
        send_idx = []
        for d in deltas:
            S = max((len(v) for (src, dst), v in ghost_by_pair.items()
                     if (dst - src) % D == d), default=1)
            seg_sizes.append(S)
            tbl = np.zeros((D, S), dtype=np.int32)  # pad -> slot 0 (unread)
            for src in range(D):
                ids = ghost_by_pair.get((src, (src + d) % D))
                if ids is not None:
                    tbl[src, : len(ids)] = ids - node_start[src]
            send_idx.append(tbl)
        Gtot = int(np.sum(seg_sizes)) if seg_sizes else 0
        seg_off = np.concatenate([[0], np.cumsum(seg_sizes)]).astype(int)

        # ---- local connectivity: owned slot or ghost slot -----------------
        Nloc = No_max + Gtot
        conn_local = np.zeros((D, K, Eb), dtype=np.int32)
        ghost_slot_maps: List[Dict[int, int]] = []
        for s in range(D):
            gmap: Dict[int, int] = {}
            for di, d in enumerate(deltas):
                ids = ghost_by_pair.get(((s - d) % D, s))
                if ids is not None:
                    base = No_max + seg_off[di]
                    for p, g in enumerate(ids):
                        gmap[int(g)] = base + p
            ghost_slot_maps.append(gmap)
            ce = conn_sorted[e_starts[s]:e_starts[s + 1]]  # (E_s, K)
            lo = node_start[s]
            loc = np.empty_like(ce, dtype=np.int32)
            owned_mask = (ce >= lo) & (ce < node_start[s + 1])
            loc[owned_mask] = (ce[owned_mask] - lo).astype(np.int32)
            if (~owned_mask).any():
                loc[~owned_mask] = np.array(
                    [gmap[int(g)] for g in ce[~owned_mask]], dtype=np.int32)
            conn_local[s, :, : len(ce)] = loc.T  # pad elements: slot 0

        # ---- constraint tables in local slots ------------------------------
        has_cons = cons_r is not None
        cons_all = None
        hang_mask = None
        if has_cons:
            rows_per_shard: List[List[Tuple[int, int, int]]] = []
            for s in range(D):
                lo, hi = node_start[s], node_start[s + 1]
                gmap = ghost_slot_maps[s]
                slot = lambda g: int(g) - lo if lo <= g < hi else gmap[int(g)]
                vis = set(int(g) for g in shard_nodes[s])
                rows_per_shard.append(
                    [(slot(h), slot(a), slot(b)) for h, a, b in cons_r
                     if int(h) in vis])
            Hmax = max(max((len(r) for r in rows_per_shard), default=0), 1)
            cons_all = np.full((D, 3, Hmax), Nloc, dtype=np.int32)
            for s, rows in enumerate(rows_per_shard):
                if rows:
                    cons_all[s, :, : len(rows)] = np.asarray(
                        rows, dtype=np.int64).T
            hang_mask = np.ones((D, No_max))
            for s in range(D):
                lo, hi = node_start[s], node_start[s + 1]
                own_h = cons_r[(cons_r[:, 0] >= lo) & (cons_r[:, 0] < hi), 0]
                hang_mask[s, own_h - lo] = 0.0

        # ---- restriction (inverse-connectivity) tables --------------------
        node_gather = _restriction_tables(
            conn_local, e_starts[1:] - e_starts[:-1], Nloc)

        # ---- reverse-add tables -------------------------------------------
        # after the reverse exchange, shard t holds rcat = the returned
        # partial-sum buffers concatenated over deltas; owned slot n sums
        # rcat positions seg_off[di] + p wherever n sits at position p of
        # t's delta-di send list.  pad = Gtot (a zero column).
        rev_lists: List[List[List[int]]] = [
            [[] for _ in range(No_max)] for _ in range(D)]
        for di, d in enumerate(deltas):
            for src in range(D):
                ids = ghost_by_pair.get((src, (src + d) % D))
                if ids is None:
                    continue
                for p, g in enumerate(ids):
                    rev_lists[src][g - node_start[src]].append(
                        seg_off[di] + p)
        Cr = max(max((len(l) for per in rev_lists for l in per), default=0),
                 1)
        rev_gather = np.full((D, Cr, No_max), Gtot, dtype=np.int32)
        for s in range(D):
            for n, l in enumerate(rev_lists[s]):
                rev_gather[s, : len(l), n] = l

        return HaloPlan(
            D=D, n_nodes=N, n_elems=E, No_max=No_max, Eb=Eb, Gtot=Gtot,
            deltas=tuple(deltas), seg_sizes=tuple(seg_sizes),
            owned_counts=owned_counts, elem_counts=e_counts,
            node_order=node_order, node_rank=node_rank,
            node_start=node_start, elem_order=elem_order,
            conn_local=conn_local, node_gather=node_gather,
            send_idx=send_idx, rev_gather=rev_gather,
            has_cons=has_cons, cons_all=cons_all, hang_mask=hang_mask)


def _restriction_tables(conn_local: np.ndarray, elem_counts: np.ndarray,
                        Nloc: int) -> np.ndarray:
    """node_gather[s, c, slot] = flat (k * Eb + e_local) corner index of
    the c-th contribution to local slot, pad = K * Eb."""
    D, K, Eb = conn_local.shape
    tables = []
    Cmax = 1
    for s in range(D):
        E_s = int(elem_counts[s])
        flat_targets = conn_local[s].reshape(-1)  # (K * Eb,) k-major
        e_ids = np.tile(np.arange(Eb), K)
        valid = np.nonzero(e_ids < E_s)[0]
        order = valid[np.argsort(flat_targets[valid], kind="stable")]
        tgt = flat_targets[order]
        counts = np.bincount(tgt, minlength=Nloc)
        Cs = int(counts.max()) if len(tgt) else 1
        Cmax = max(Cmax, Cs)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        tbl = np.full((Cs, Nloc), K * Eb, dtype=np.int32)
        pos = np.arange(len(tgt)) - starts[tgt]
        tbl[pos, tgt] = order
        tables.append(tbl)
    node_gather = np.full((D, Cmax, Nloc), K * Eb, dtype=np.int32)
    for s, tbl in enumerate(tables):
        node_gather[s, : tbl.shape[0]] = tbl
    return node_gather


def build_mixed_plan(mesh, D: int,
                     constraints: Optional[np.ndarray] = None
                     ) -> Tuple[HaloPlan, List[dict]]:
    """(HaloPlan, per-block tables) of a MixedMesh on D shards (the
    reference's build_mixed_plan, table for table).

    The node-side plan is built once over the K_max-padded concatenation
    of the blocks' connectivities (padding repeats each element's corner
    0, so no shard sees another node); the hanging-node rows ride it as
    on a single-type mesh.  Each block's element tables are then split
    back out: per block its elem_type, counts (D,), conn_local (D, K, Eb)
    (the rows of the plan's conn_local; Eb its largest shard count, at
    least 1), conn_sorted (the renumbered connectivity of its elements in
    shard order) and sorted_concat_idx (their positions in the plan's
    shard-sorted element order).  The reference's per-block restriction
    tables are not built: a shard's one K4 table over its blocks is
    (HaloShardedSystem._make_shards)."""
    blocks = mesh.blocks
    Kmax = max(b.connectivity.shape[1] for b in blocks)
    conns, block_of = [], []
    for bi, b in enumerate(blocks):
        c = b.connectivity.astype(np.int64)
        if c.shape[1] < Kmax:
            c = np.concatenate(
                [c, np.repeat(c[:, :1], Kmax - c.shape[1], axis=1)], axis=1)
        conns.append(c)
        block_of.append(np.full(len(c), bi, dtype=np.int64))
    conn_pad = np.concatenate(conns, axis=0)
    block_of = np.concatenate(block_of)
    plan = HaloPlan.build(SimpleNamespace(
        connectivity=conn_pad, n_nodes=mesh.n_nodes, coords=mesh.coords),
        D, constraints=constraints)

    block_sorted = block_of[plan.elem_order]
    e_starts = np.concatenate([[0], np.cumsum(plan.elem_counts)])
    per_block = []
    for bi, b in enumerate(blocks):
        Kb = b.connectivity.shape[1]
        sel = [np.nonzero(block_sorted[e_starts[s]:e_starts[s + 1]]
                          == bi)[0] for s in range(D)]
        counts = np.array([len(x) for x in sel])
        Eb = max(int(counts.max()), 1)
        conn_local = np.zeros((D, Kb, Eb), dtype=np.int32)
        for s in range(D):
            conn_local[s, :, : len(sel[s])] = plan.conn_local[s][:Kb, sel[s]]
        order = np.concatenate([e_starts[s] + sel[s] for s in range(D)])
        per_block.append({
            "elem_type": b.elem_type, "counts": counts,
            "conn_local": conn_local,
            "conn_sorted": plan.node_rank[
                conn_pad[plan.elem_order[order]]][:, :Kb],
            "sorted_concat_idx": order,
        })
    return plan, per_block


class BlockLayout(NamedTuple):
    """One element block's place in a plan: its type, its renumbered
    connectivity in shard order (E_b, K), its element count per shard
    (D,), its local connectivity (D, K, Eb) and its block-local element
    ids in shard order (E_b,)."""

    elem_type: str
    conn_sorted: np.ndarray
    counts: np.ndarray
    conn_local: np.ndarray
    ids: np.ndarray

    def shard_conn(self, s: int) -> np.ndarray:
        """Shard s's local connectivity (E_s, K), unpadded."""
        return self.conn_local[s][:, : int(self.counts[s])].T

    def shard_ids(self, s: int) -> np.ndarray:
        """The block-local ids of shard s's elements, in its order."""
        a = int(self.counts[:s].sum())
        return self.ids[a:a + int(self.counts[s])]


def plan_blocks(mesh, D: int, constraints: Optional[np.ndarray] = None
                ) -> Tuple[HaloPlan, List[BlockLayout]]:
    """The plan of a single-type Mesh (one block) or a MixedMesh
    (build_mixed_plan, one block per type) on D shards, and each block's
    BlockLayout."""
    if mesh.elem_type == "MIXED":
        plan, per_block = build_mixed_plan(mesh, D, constraints=constraints)
        starts = np.cumsum([0] + [b.n_elems for b in mesh.blocks])
        return plan, [BlockLayout(
            pb["elem_type"], pb["conn_sorted"], pb["counts"],
            pb["conn_local"],
            plan.elem_order[pb["sorted_concat_idx"]] - starts[bi])
            for bi, pb in enumerate(per_block)]
    plan = HaloPlan.build(mesh, D, constraints=constraints)
    return plan, [BlockLayout(
        mesh.elem_type,
        plan.node_rank[np.asarray(mesh.connectivity)][plan.elem_order],
        plan.elem_counts, plan.conn_local, plan.elem_order)]


# ----------------------------------------------------------------------
# shards in one process
# ----------------------------------------------------------------------
def shard_devices(n: int, device=None,
                  cuda_count: Optional[int] = None) -> List[torch.device]:
    """The devices of n shards.  device None is the card (RuntimeError
    without one); a CPU device gives every shard the CPU; a CUDA device
    cuda:i gives shard s cuda:((i + s) mod cuda_count), cuda_count
    defaulting to torch.cuda.device_count(), so one card takes them all.
    Never the CPU when a card was asked for."""
    base = cuda_device() if device is None else torch.device(device)
    if base.type == "cpu":
        return [base] * n
    if base.type != "cuda":
        raise ValueError(f"shards run on the CPU or on CUDA devices, not "
                         f"{base}")
    count = torch.cuda.device_count() if cuda_count is None else cuda_count
    if count < 1:
        raise RuntimeError("no CUDA device: shards asked for the card")
    i0 = base.index or 0
    return [torch.device("cuda", (i0 + s) % count) for s in range(n)]


class ShardGroup:
    """D shards, each on its own torch device (repeats allowed): the
    collectives of the reference's shard_map program, run in one
    process."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]

    @property
    def D(self) -> int:
        return len(self.devices)

    def ppermute(self, bufs: Sequence[torch.Tensor], delta: int
                 ) -> List[torch.Tensor]:
        """Shard i's buffer to shard (i + delta) mod D (lax.ppermute)."""
        D = self.D
        out: List[Optional[torch.Tensor]] = [None] * D
        for i, b in enumerate(bufs):
            j = (i + delta) % D
            out[j] = b.to(self.devices[j])
        return out

    def psum(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        """The per-shard scalars added in shard order, on shard 0's
        device."""
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v.to(acc.device)
        return acc


class Shard:
    """One shard's tables on its device: `parts`, one (block index,
    ElementBlock, Geometry) per element block the shard holds elements
    of (the ElementBlock over its local connectivity (K, E_sb) into the
    (V, Nloc) slab; the Geometry None on a moving mesh), the K4 tables (node_gather over the parts' corner
    values concatenated in block order, None when the shard holds no
    element; rev_gather with pad Gtot), the send tables per delta, the
    owned-slot masks and its hanging-node rows."""

    def __init__(self, device, parts: List[Tuple[int, ElementBlock,
                                                  Geometry]],
                 node_gather: Optional[torch.Tensor],
                 rev_gather: torch.Tensor, send: List[torch.Tensor],
                 mask: torch.Tensor, it_mask: torch.Tensor,
                 cons: Optional[Constraints]):
        self.device = device
        self.parts = parts
        self.node_gather = node_gather
        self.rev_gather = rev_gather
        self.send = send
        self.mask = mask          # real owned slots
        self.it_mask = it_mask    # real owned slots, not hanging
        self.cons = cons


class HaloExchange:
    """The host transfers and the exchanges of a system on a HaloPlan's
    shards.  A subclass sets `plan`, `group`, `ops` and `shards` (each
    with `send`, its per-delta send slots, and `rev_gather`, its K4
    reverse-add table)."""

    plan: HaloPlan
    group: "ShardGroup"
    ops: Ops

    def scatter_nodal(self, arr) -> List[torch.Tensor]:
        """(N, W) global, original node order -> D slabs (W, No_max)."""
        plan = self.plan
        a = np.asarray(arr, dtype=np.float64)[plan.node_order]
        out = []
        for s, dev in enumerate(self.group.devices):
            lo, hi = plan.node_start[s], plan.node_start[s + 1]
            slab = np.zeros((a.shape[1], plan.No_max))
            slab[:, : hi - lo] = a[lo:hi].T
            out.append(torch.as_tensor(slab, device=dev))
        return out

    def gather(self, u: Sequence[torch.Tensor]) -> np.ndarray:
        """D slabs (W, No_max) -> (N, W) global, original node order."""
        plan = self.plan
        full = np.empty((plan.n_nodes, u[0].shape[0]))
        for s, slab in enumerate(u):
            lo, hi = plan.node_start[s], plan.node_start[s + 1]
            full[lo:hi] = slab[:, : hi - lo].detach().cpu().numpy().T
        out = np.empty_like(full)
        out[plan.node_order] = full
        return out

    def ghost_fill(self, x: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """D slabs (W, No_max) -> (W, No_max + Gtot) with the ghosts
        filled, one exchange per offset class (VecScatter forward)."""
        parts = [[xs] for xs in x]
        for di, d in enumerate(self.plan.deltas):
            bufs = [xs[:, sh.send[di]] for xs, sh in zip(x, self.shards)]
            for s, r in enumerate(self.group.ppermute(bufs, d)):
                parts[s].append(r)
        return [torch.cat(p, dim=1) if len(p) > 1 else p[0] for p in parts]

    def reverse_add(self, y_all: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Local sums (W, No_max + Gtot) -> owned (W, No_max): each ghost
        segment goes back to its owner (offset -d), where K4 sums the
        returned partials through rev_gather (VecScatter reverse, ADD)."""
        plan = self.plan
        No = plan.No_max
        if not plan.deltas:
            return [ya[:, :No] for ya in y_all]
        back: List[List[torch.Tensor]] = [[] for _ in y_all]
        off = No
        for d, S in zip(plan.deltas, plan.seg_sizes):
            segs = [ya[:, off:off + S] for ya in y_all]
            for s, r in enumerate(self.group.ppermute(segs, -d)):
                back[s].append(r)
            off += S
        return [ya[:, :No] + self.ops.restrict(torch.cat(bk, dim=1),
                                                sh.rev_gather)
                for ya, bk, sh in zip(y_all, back, self.shards)]

    def _restrict_onto(self, table: Optional[torch.Tensor],
                       parts: List[torch.Tensor], W: int,
                       device) -> torch.Tensor:
        """K4 of per-block values (W, ..., K_b, E_b), flattened and
        concatenated in block order, through `table` onto a (W, Nloc)
        slab; zeros where there is nothing to restrict."""
        if not parts:
            return torch.zeros((W, self.plan.No_max + self.plan.Gtot),
                               dtype=torch.float64, device=device)
        flat = [p.reshape(W, -1) for p in parts]
        flat = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
        return self.ops.restrict(flat, table)


class HaloShardedSystem(HaloExchange):
    """The transient RDC system on D shards: the reference's
    HaloShardedSystem.  State entries are lists of D (V, No_max) slabs,
    one per shard on its device; `gather` rebuilds the global (N, V)
    array in the original node order.

    mesh            : a single-type Mesh of any type TransientRDCSystem
                      takes (TET4, HEX8, TET10, HEX20, HEX27, TRI3,
                      QUAD4, QUAD8, QUAD9), or a MixedMesh (TET4, HEX8,
                      PRISM6, PYRAMID5 blocks)
    n_vars          : number of coupled nodal variables V
    n_shards        : D
    physics_blocks  : the qp path's WeakFormBlocks callable, or None
    physics         : the dense path's WeakForm callable (keyword)
    clamp, rtol, maxiter : as TransientRDCSystem (the reference's halo
                      step solves in f64 with BiCGStab)
    constraints     : (H, 3) hanging-node rows [h, a, b] in original ids
    moving_mesh     : the geometry follows the `coords` (N, 3) that step
                      and run_steps are given (required then)
    device          : the placement (shard_devices): None the card
    ops             : fem.kernels.KERNEL_OPS (default) or PLAIN_OPS

    `fields` of step/run_steps: per-shard lists from shard_elem_field
    (on a MixedMesh each entry a tuple of one tensor per block), or
    plain numbers.  `step` takes the qp path when physics_blocks is given
    and every param is a plain number, the dense path otherwise."""

    def __init__(self, mesh, n_vars: int, n_shards: int,
                 physics_blocks: Optional[Callable] = None,
                 clamp: Callable = clamp_nonnegative,
                 rtol: float = DEFAULT_RTOL,
                 maxiter: int = DEFAULT_MAXITER,
                 constraints: Optional[np.ndarray] = None,
                 moving_mesh: bool = False, device=None,
                 ops: Ops = KERNEL_OPS, physics: Optional[Callable] = None):
        mixed = mesh.elem_type == "MIXED"
        if not mixed and mesh.elem_type not in _ELEMENT_TYPES:
            raise ValueError(f"{mesh.elem_type} meshes in "
                             f"HaloShardedSystem")
        if physics_blocks is None and physics is None:
            raise ValueError("a transient system needs physics_blocks or "
                             "physics=")
        self.mesh = mesh
        self.n_vars = n_vars
        self.physics_blocks = physics_blocks
        self.physics = physics
        self.clamp = clamp
        self.rtol = rtol
        self.maxiter = maxiter
        self.ops = ops
        self.group = ShardGroup(shard_devices(n_shards, device))
        self.device = self.group.devices[0]
        self.moving_mesh = bool(moving_mesh)
        self._coords_cache = None  # (the coords scattered, their slabs)
        self.plan, self._layout = plan_blocks(mesh, n_shards, constraints)
        self.shards = self._make_shards(self.plan)

    @property
    def n_blocks(self) -> int:
        """The element blocks (one on a single-type mesh)."""
        return len(self._layout)

    def _make_shards(self, plan: HaloPlan) -> List[Shard]:
        """Each shard's tables; on a fixed mesh each block's geometry
        sliced from the one built on the renumbered mesh, its elements in
        shard order (unpadded: pad elements would have a degenerate
        Jacobian).  A moving mesh's parts carry no geometry: step and
        run_steps build it from their coords."""
        Nloc = plan.No_max + plan.Gtot
        g_all = None
        if not self.moving_mesh:
            coords_new = torch.as_tensor(
                self.mesh.coords[plan.node_order], dtype=torch.float64,
                device=self.device)
            g_all = [ElementBlock(b.elem_type, b.conn_sorted,
                                  self.device).geometry(coords_new)
                     for b in self._layout]
        shards = []
        for s, dev in enumerate(self.group.devices):
            as_t = lambda x, dt=None: torch.tensor(
                np.ascontiguousarray(x), dtype=dt, device=dev)
            parts, conns = [], []
            for bi, b in enumerate(self._layout):
                n = int(b.counts[s])
                if n == 0:
                    continue  # no element of this block: nothing to launch
                a = int(b.counts[:s].sum())
                conn = b.shard_conn(s)
                conns.append(conn)
                g = None if g_all is None else Geometry(
                    *(t[..., a:a + n].contiguous().to(dev)
                      for t in g_all[bi]))
                parts.append((bi, ElementBlock(b.elem_type, conn, dev), g))
            node_gather = (as_t(block_node_gather(conns, Nloc)) if conns
                           else None)
            mask = np.zeros(plan.No_max)
            mask[: plan.owned_counts[s]] = 1.0
            cons = None
            it_mask = mask
            if plan.has_cons:
                rows = plan.cons_all[s].T
                rows = rows[rows[:, 0] < Nloc]  # drop the pad rows
                if len(rows):
                    cons = Constraints(rows, dev)
                it_mask = mask * plan.hang_mask[s]
            shards.append(Shard(
                dev, parts, node_gather, as_t(plan.rev_gather[s]),
                [as_t(t[s], torch.int64) for t in plan.send_idx],
                as_t(mask, torch.float64), as_t(it_mask, torch.float64),
                cons))
        return shards

    # ------------------------------------------------------------------
    # host <-> shards
    # ------------------------------------------------------------------
    def initial_state(self, u0) -> Dict[str, List[torch.Tensor]]:
        u0 = np.asarray(u0, dtype=np.float64)
        if u0.shape != (self.mesh.n_nodes, self.n_vars):
            raise ValueError(f"u0 shape {u0.shape}, expected "
                             f"{(self.mesh.n_nodes, self.n_vars)}")
        u = self.scatter_nodal(u0)
        return {"u": u, "u_old": u, "u_older": u, "u_raw": u}

    def gather_state(self, state: Dict) -> Dict[str, np.ndarray]:
        return {k: self.gather(v) for k, v in state.items()}

    def scatter_state(self, gstate: Dict) -> Dict[str, List[torch.Tensor]]:
        return {k: self.scatter_nodal(v) for k, v in gstate.items()}

    def shard_elem_field(self, arr, axis: int = -1) -> List:
        """An elemental field -> D per-shard entries, each shard's elements
        in its order along the same axis (the reference's shard_elem_field
        without its zero padding).

        On a single-type mesh `arr` has its element axis `axis` in the
        original element order, and each entry is a tensor.  On a
        MixedMesh `arr` is either one array whose axis `axis` runs over
        the block-concatenated element order (ADPM's tracts, axis 0), or
        a tuple or list of one array per block with its elements on axis
        `axis` (PROTEAS's dose at each block's quadrature points); each
        entry is then a tuple of one tensor per block (empty where the
        shard holds none of the block's elements)."""
        mixed = self.mesh.elem_type == "MIXED"
        if isinstance(arr, (tuple, list)):
            if not mixed or len(arr) != self.n_blocks:
                raise ValueError(f"a per-block field takes one array per "
                                 f"block of a MixedMesh "
                                 f"({self.n_blocks} here)")
            per_block = [np.moveaxis(np.asarray(a), axis, -1) for a in arr]
        else:
            a = np.moveaxis(np.asarray(arr), axis, -1)
            if a.shape[-1] != self.plan.n_elems:
                raise ValueError(f"axis {axis} has {a.shape[-1]} entries, "
                                 f"expected {self.plan.n_elems} elements")
            starts = np.cumsum([0] + [len(b.ids) for b in self._layout])
            per_block = [a[..., lo:hi]
                         for lo, hi in zip(starts[:-1], starts[1:])]
        out = [[] for _ in self.group.devices]
        for a, (_, _, counts, _, ids) in zip(per_block, self._layout):
            if a.shape[-1] != len(ids):
                raise ValueError(f"a block field has {a.shape[-1]} "
                                 f"elements, expected {len(ids)}")
            perm = a[..., ids]
            dt = (torch.float64 if np.issubdtype(a.dtype, np.floating)
                  else None)
            off = np.concatenate([[0], np.cumsum(counts)])
            for s, dev in enumerate(self.group.devices):
                out[s].append(torch.as_tensor(np.ascontiguousarray(
                    np.moveaxis(perm[..., off[s]:off[s + 1]], -1, axis)),
                    dtype=dt, device=dev))
        return [tuple(o) if mixed else o[0] for o in out]

    @property
    def processor_id(self) -> np.ndarray:
        """(E,) owning shard of each element, original (on a MixedMesh
        block-concatenated) element order (the VTU's processor_id,
        reference paraview.h:113-117)."""
        plan = self.plan
        out = np.empty(plan.n_elems, dtype=np.int32)
        out[plan.elem_order] = np.repeat(np.arange(plan.D),
                                         plan.elem_counts)
        return out

    def _fold(self, sh: Shard, y: torch.Tensor, w: float) -> torch.Tensor:
        """C^T on a shard's local partial sums: w y_h onto both masters,
        y_h = 0 (w = 0.5 for vectors, 0.25 for the block-Jacobi's own-row
        C^T A C blocks)."""
        return y if sh.cons is None else sh.cons.pin(sh.cons.fold(y, w))

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _block_fields(self, s: int, bi: int, fields: Dict) -> Dict:
        """The fields of block bi on shard s: entry s of a per-shard list,
        then entry bi of a per-block tuple; anything else (a number) as
        it is."""
        out = {}
        for k, v in fields.items():
            if isinstance(v, list):
                v = v[s]
            out[k] = v[bi] if isinstance(v, tuple) else v
        return out

    def _restrict(self, sh: Shard, parts: List[torch.Tensor],
                  W: int) -> torch.Tensor:
        """K4 of a shard's per-block corner values (W, ..., K_b, E_b),
        concatenated in block order, onto its local (W, Nloc) slab; zeros
        on a shard that holds no element."""
        return self._restrict_onto(sh.node_gather, parts, W, sh.device)

    def _parts(self, s: int, geoms) -> List[Tuple[int, ElementBlock,
                                                  Geometry]]:
        """Shard s's (block index, ElementBlock, Geometry) triples, with
        the geometries of `geoms[s]` when a moving step built them."""
        parts = self.shards[s].parts
        if geoms is None:
            return parts
        return [(bi, blk, g) for (bi, blk, _), g in zip(parts, geoms[s])]

    def _qp_element_stage(self, ug, fields, params, geoms=None):
        """The qp path's element work on every shard and block: K1/K8
        gather and interpolation, the blocks, K2 (or block_rhs), and one
        K4 onto the local slab.  Returns (local b, local diagonal blocks,
        the operator's local apply)."""
        V, ops = self.n_vars, self.ops
        bl, dl, stacks = [], [], []
        for s, sh in enumerate(self.shards):
            rhs, diag, st = [], [], []
            for bi, blk, g in self._parts(s, geoms):
                u_qp, grad_qp = blk.interp(ops, ug[s], g)
                wfb = self.physics_blocks(
                    u_qp, grad_qp, self._block_fields(s, bi, fields),
                    params).cast(torch.float64)
                rhs.append(blk.rhs(ops, wfb, g))
                diag.append(blk.diag(wfb, g))
                st.append(blk.stacks(wfb, g.JxW))
            bl.append(self._restrict(sh, rhs, V))
            dl.append(self._restrict(sh, diag, V * V))
            stacks.append(st)

        def local_apply(s: int, xg: torch.Tensor) -> torch.Tensor:
            sh = self.shards[s]
            return self._restrict(sh, [
                blk.apply(ops, xg, st, g.JxW, g.dphi)
                for (_, blk, g), st in zip(self._parts(s, geoms),
                                           stacks[s])], V)

        return bl, dl, local_apply

    def _dense_element_stage(self, ug, fields, params, geoms=None):
        """The dense path's element work on every shard and block: Fe, Ke
        and the diagonal blocks of the WeakForm, one batched product a
        block and matvec."""
        if self.physics is None:
            raise ValueError("the dense path needs physics= (a WeakForm "
                             "callable); the qp path needs plain-scalar "
                             "params")
        V, ops = self.n_vars, self.ops
        bl, dl, KeBs = [], [], []
        for s, sh in enumerate(self.shards):
            kern = []
            for bi, blk, g in self._parts(s, geoms):
                u_qp, grad_qp = blk.interp(ops, ug[s], g)
                wf = self.physics(u_qp, grad_qp,
                                  self._block_fields(s, bi, fields), params)
                kern.append(blk.element_kernels(wf, g))
            bl.append(self._restrict(sh, [Fe for Fe, _, _ in kern], V))
            dl.append(self._restrict(sh, [d for _, _, d in kern], V * V))
            KeBs.append([ElementBlock.batched(Ke) for _, Ke, _ in kern])

        def local_apply(s: int, xg: torch.Tensor) -> torch.Tensor:
            sh = self.shards[s]
            return self._restrict(sh, [
                blk.dense_apply(KB, xg)
                for (_, blk, _), KB in zip(sh.parts, KeBs[s])], V)

        return bl, dl, local_apply

    def _step_body(self, state, fields, params, qp: bool, geoms=None):
        """One halo step (the reference's _step_shard_qp_fn step_shard and
        _step_shard with _linear_stage_blocks; with `geoms`, the moving
        mesh's _step_shard_moving and _step_shard_moving_mixed, served on
        the qp path when it can be).  Returns (new_state, iterations,
        residual)."""
        V, No = self.n_vars, self.plan.No_max
        shards, group = self.shards, self.group
        stage = self._qp_element_stage if qp else self._dense_element_stage
        bl, dl, local_apply = stage(self.ghost_fill(state["u"]), fields,
                                    params, geoms)
        b = self.reverse_add([self._fold(sh, x, 0.5)
                              for sh, x in zip(shards, bl)])
        diag = self.reverse_add([self._fold(sh, x, 0.25)
                                 for sh, x in zip(shards, dl)])
        Dinv = []
        for dg in diag:
            dg = dg.reshape(V, V, No)
            # empty rows (pad and hanging slots) get an identity block
            empty = dg.abs().sum(dim=(0, 1)) == 0.0
            eye = torch.eye(V, dtype=dg.dtype, device=dg.device)
            dg = torch.where(empty[None, None, :], eye[:, :, None], dg)
            Dinv.append(small_block_inverse(dg, pivot=False))

        def matvec(x):
            xg = self.ghost_fill(x)
            yl = []
            for s, sh in enumerate(shards):
                xs = xg[s] if sh.cons is None else sh.cons.c_apply(xg[s])
                yl.append(self._fold(sh, local_apply(s, xs), 0.5))
            return self.reverse_add(yl)

        def pre_matvec(x):
            return [apply_block_jacobi(di, y)
                    for di, y in zip(Dinv, matvec(x))]

        msk_it = [sh.it_mask for sh in shards]
        pre_b = [apply_block_jacobi(di, bs) * m
                 for di, bs, m in zip(Dinv, b, msk_it)]
        x0 = [(2.0 * u - uo) * m for u, uo, m
              in zip(state["u"], state["u_old"], msk_it)]
        x, iters, res = _bicgstab_dist(pre_matvec, pre_b, x0, msk_it, group,
                                       self.rtol, self.maxiter)
        if self.plan.has_cons:
            # hanging values follow the solved masters; clamp on the
            # ghost-filled vector, then derive them again
            xg = self.ghost_fill([xs * m for xs, m in zip(x, msk_it)])
            u_raw, u_new = [], []
            for s, sh in enumerate(shards):
                xs = xg[s] if sh.cons is None else sh.cons.c_apply(xg[s])
                cl = self.clamp(xs)
                cl = cl if sh.cons is None else sh.cons.c_apply(cl)
                u_raw.append(xs[:, :No] * sh.mask)
                u_new.append(cl[:, :No] * sh.mask)
        else:
            u_raw = [xs * sh.mask for xs, sh in zip(x, shards)]
            u_new = [self.clamp(r) for r in u_raw]
        new_state = {"u": u_new, "u_old": state["u"],
                     "u_older": state["u_old"], "u_raw": u_raw}
        return new_state, iters, res

    # ------------------------------------------------------------------
    # the moving mesh
    # ------------------------------------------------------------------
    def scatter_coords(self, coords) -> List[torch.Tensor]:
        """Node positions (N, 3) (an array or a tensor) -> D (3, No_max)
        slabs, cached by the identity of `coords` (the coupled driver
        moves the mesh only at its loading points; the cache holds the
        object, so its identity is not reused)."""
        cached = self._coords_cache
        if cached is not None and cached[0] is coords:
            return cached[1]
        host = (coords.detach().cpu().numpy() if torch.is_tensor(coords)
                else np.asarray(coords))
        slabs = self.scatter_nodal(host)
        self._coords_cache = (coords, slabs)
        return slabs

    def moving_geometry(self, coords) -> List[List[Geometry]]:
        """Per shard, its blocks' Geometry at the positions `coords`:
        scatter_coords, ghost_fill, then each block's geometry from the
        shard's own (Nloc, 3) slab through its local connectivity."""
        xg = self.ghost_fill(self.scatter_coords(coords))
        return [[blk.geometry(xg[s].T.contiguous()) for _, blk, _ in
                 sh.parts] for s, sh in enumerate(self.shards)]

    def _step_geoms(self, coords):
        """The geometries of a step or run_steps call: built from coords
        when given (on any mesh, as the reference's halo step), None (the
        fixed geometry) otherwise; a moving mesh needs coords."""
        if coords is not None:
            return self.moving_geometry(coords)
        if self.moving_mesh:
            raise ValueError("a moving_mesh system needs the current "
                             "coords")
        return None

    def step(self, state: Dict, fields: Optional[Dict] = None,
             params: Optional[Dict] = None, coords=None,
             scalars: Optional[Dict] = None):
        """Advance one step.  Returns (new_state, iterations, residual).
        The qp path when the system has physics_blocks and every param is
        a plain number, else the dense path (the reference's dispatch).
        `coords` (N, 3): the positions the geometry is built from, on
        every call (the moving mesh)."""
        geoms = self._step_geoms(coords)
        fields = {**(fields or {}), **(scalars or {})}
        p = TransientRDCSystem._plain_params(params)
        if self.physics_blocks is not None and p is not None:
            return self._step_body(state, fields, p, qp=True, geoms=geoms)
        return self._step_body(state, fields, dict(params or {}), qp=False,
                               geoms=geoms)

    def run_steps(self, state: Dict, n: int, fields: Optional[Dict] = None,
                  params: Optional[Dict] = None,
                  scalars: Optional[Dict] = None, coords=None,
                  scalar_traj: Optional[Dict] = None,
                  field_update: Optional[Callable] = None, field_aux=None,
                  field_args=()):
        """n qp steps, one `step` after the other (the reference's
        run_steps(n, segment=n) on a fixed mesh; on a MixedMesh the
        reference steps one at a time too).  Returns (state, iterations
        (n,) int64 on the CPU, residuals (n,) on shard 0's device), plus
        the final field_update carry when field_update is given.

        `scalar_traj` maps a scalar-field name to its (n,) per-step
        values; `field_update(state, aux, tr, *field_args) -> (fields,
        new_aux)` runs before each step on the sharded state (RIPF's
        fields from the carried solution; the fields it returns are
        per-shard lists, on a MixedMesh of per-block tuples).

        `coords` (N, 3): the positions of the moving mesh, whose geometry
        is built once for the n steps (the reference builds it once a
        segment, and every step on a MixedMesh: the same numbers)."""
        if self.physics_blocks is None:
            raise ValueError("run_steps needs physics_blocks (the qp "
                             "path), as the reference's does")
        p = TransientRDCSystem._plain_params(params)
        if p is None:
            raise ValueError("run_steps needs plain-scalar params")
        n = int(n)
        traj = {k: np.asarray(v, dtype=np.float64)
                for k, v in (scalar_traj or {}).items()}
        for k, v in traj.items():
            if v.shape != (n,):
                raise ValueError(f"scalar_traj[{k!r}] must have shape "
                                 f"({n},), got {v.shape}")
        geoms = self._step_geoms(coords)
        fields = {**(fields or {}), **(scalars or {})}
        aux = field_aux
        its, ress = [], []
        for i in range(n):
            tr = {k: float(v[i]) for k, v in traj.items()}
            f = {**fields, **tr}
            if field_update is not None:
                fu, aux = field_update(state, aux, tr, *field_args)
                f = {**f, **fu}
            state, it, res = self._step_body(state, f, p, qp=True,
                                             geoms=geoms)
            its.append(it)
            ress.append(res)
        ress = (torch.stack(ress) if ress else
                torch.empty(0, dtype=torch.float64, device=self.device))
        out = (state, torch.tensor(its, dtype=torch.int64), ress)
        return out + ((aux,) if field_update is not None else ())


def _bicgstab_dist(matvec: Callable, b: List[torch.Tensor],
                   x0: List[torch.Tensor], msk: List[torch.Tensor],
                   group: ShardGroup, rtol: float, maxiter: int):
    """BiCGStab on node-partitioned vectors (lists of shard slabs): local
    arithmetic, dots summed over the shards.  The recurrence, breakdown
    freezes and stopping rule of the reference's _bicgstab_dist (and of
    solvers.krylov.bicgstab): stop when |r|^2 <= (rtol |b|)^2 or after
    maxiter iterations; a breakdown keeps the last iterate and reports
    maxiter.  Returns (x, iterations, |r| / |b| 0-d on shard 0's
    device)."""
    def pdot(a, c):
        return group.psum([_dot(ai, ci) for ai, ci in zip(a, c)])

    def axpy(*terms):
        """sum of coef * vec over the shards; coef a 0-d tensor or 1."""
        out = []
        for s, dev in enumerate(group.devices):
            acc = None
            for coef, vec in terms:
                t = vec[s] if coef is None else coef.to(dev) * vec[s]
                acc = t if acc is None else acc + t
            out.append(acc)
        return out

    def masked(y):
        return [ys * m for ys, m in zip(y, msk)]

    bnorm = torch.sqrt(pdot(b, b))
    safe_b = torch.where(bnorm == 0.0, 1.0, bnorm)
    atol2 = (rtol * safe_b) ** 2
    x = x0
    r = masked([bs - ys for bs, ys in zip(b, matvec(x0))])
    rhat = r
    p = [torch.zeros_like(bs) for bs in b]
    v = [torch.zeros_like(bs) for bs in b]
    one = torch.ones((), dtype=b[0].dtype, device=b[0].device)
    rho, alpha, omega = one, one, one
    safe = lambda d: torch.where(d == 0.0, 1.0, d)
    k = 0
    go = bool(pdot(r, r) > atol2) and maxiter > 0
    while go:
        rho1 = pdot(rhat, r)
        beta = (rho1 / safe(rho)) * (alpha / safe(omega))
        # p = r + beta (p - omega v)
        p = axpy((None, r), (beta, axpy((None, p), (-omega, v))))
        v = masked(matvec(p))
        rtv = pdot(rhat, v)
        alpha_new = rho1 / safe(rtv)
        st = axpy((None, r), (-alpha_new, v))
        t = masked(matvec(st))
        tt = pdot(t, t)
        omega_new = torch.where(tt == 0.0, 0.0, pdot(t, st) / safe(tt))
        breakdown = (rho1 == 0.0) | (rtv == 0.0) | (omega == 0.0)
        x_new = axpy((None, x), (alpha_new, p), (omega_new, st))
        r_new = axpy((None, st), (-omega_new, t))
        flags = torch.stack([breakdown, pdot(r_new, r_new) > atol2]).tolist()
        rho, alpha, omega = rho1, alpha_new, omega_new
        if flags[0]:
            k = maxiter
            break
        x, r = x_new, r_new
        k += 1
        go = flags[1] and k < maxiter
    return x, k, torch.sqrt(pdot(r, r)) / safe_b
