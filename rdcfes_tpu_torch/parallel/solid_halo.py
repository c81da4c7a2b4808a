"""The solid's Newton on D shards: the node-partitioned halo linear stage
(the port of rdcfes_tpu/parallel/solid_halo.py; the reference app's
libMesh FEMSystem assembling into an MPI-distributed PETSc matrix under
its inner KSP, src/solid_system.C:373-392).

It shares the transient halo system's machinery (parallel/halo.py):

* `plan_blocks` partitions the elements (RCB) and the nodes (owner
  majority) into a HaloPlan, one block per element type (a MixedMesh
  through build_mixed_plan); positions live as (3, No_max) slabs, so a
  shard holds O(N/D + boundary) of them;
* the constitutive evaluation (systems.solid.element_kernels_cf, the
  single-device code) runs on each shard's elements at its ghost-filled
  positions; the element tangents Ke stay on their shard, unpadded, and
  no global sparse matrix exists (so K5 is not on this path);
* a penalty boundary face goes to its parent element's shard, whose
  local slots hold all its corners; the faces are grouped by type (TRI3,
  QUAD4, TRI6; a MixedMesh's TRI3 and QUAD4 apart);
* residual and block-Jacobi diagonal: K4 over the shard's node_gather
  (W = 3 and 9; one table over its blocks' corners, concatenated in
  block order), K4 over each face group's fgather, then reverse_add (K4
  over rev_gather);
* the shard matvec: x gathered through the local connectivity, one
  batched product Ke ue a block (torch.bmm: the reference computes it in
  XLA, outside any Pallas kernel), the face penalty products, then the
  same restriction and reverse add; the inner solve is the distributed
  BiCGStab of parallel/halo.py on the block-Jacobi (3 x 3) preconditioned
  operator, from x0 = 0;
* the Newton loop runs on the host with the reference's stopping rules
  and residual-only line-search trials.

The solve is in f64, as the reference's (SolidSystem prints the
reference's notice and keeps the f64 tangent when asked for f32).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..fem.assembly import block_node_gather, invert_scatter
from ..fem.geometry import face_geometry_factors
from ..fem.kernels import KERNEL_OPS, Ops
from ..mesh.core import ELEMENT_FACES, FACE_TYPE
from ..solvers.krylov import apply_block_jacobi, small_block_inverse
from ..solvers.newton import NewtonOptions, NewtonResult
from ..systems.transient import ElementBlock
from .halo import HaloExchange, ShardGroup, _bicgstab_dist, plan_blocks

_MATERIALS = ("young", "poisson", "fibre_k", "rates", "fibres")


def _face_type(mesh, n_corners: int) -> str:
    """A boundary face's type: the mesh type's (TRI3, QUAD4, TRI6), or on
    a MixedMesh TRI3 or QUAD4 by its corner count."""
    if mesh.elem_type == "MIXED":
        return "TRI3" if n_corners == 3 else "QUAD4"
    return FACE_TYPE[mesh.elem_type]


class _SolidShard:
    """One shard's tables on its device: `blocks`, one dict per element
    block it holds elements of (its ElementBlock over the local
    connectivity, X0e_cf (K, 3, E_s) and the material tables); the K4
    table over their corners (None without elements); `faces`, one dict
    per face group it holds faces of (face_type, conn (F_s, Kf), X0f
    (F_s, Kf, 3), mask and disp (F_s, 3), its K4 table fgather); the
    send slots, rev_gather and the owned-slot mask."""

    def __init__(self, device, blocks, node_gather, faces, send,
                 rev_gather, mask):
        self.device = device
        self.blocks = blocks
        self.node_gather = node_gather
        self.faces = faces
        self.send = send
        self.rev_gather = rev_gather
        self.mask = mask


class HaloSolidSystem(HaloExchange):
    """Quasi-static hyperelastic equilibrium on D shards (the reference's
    HaloSolidSystem): `run_solver` takes and returns global (N, 3)
    positions; everything between is node-partitioned.

    mesh      : TET4, HEX8 or TET10 Mesh, or a MixedMesh
    young, poisson, fibre_k (E,), rates, fibres (E, 3): the per-element
              material tables in the global (on a MixedMesh
              block-concatenated) element order
    bcs       : {boundary id: (ux, uy, uz)}, NaN = free axis
    penalty   : the penalty factor of the Dirichlet conditions
    newton    : solvers.newton.NewtonOptions (the linear stage is f64
              BiCGStab whatever linear_method and linear_precision say,
              as the reference's)
    group     : the ShardGroup of the D shards
    device    : where run_solver's result lives
    ops       : fem.kernels.KERNEL_OPS (default) or PLAIN_OPS"""

    def __init__(self, mesh, young, poisson, fibre_k, rates, fibres,
                 bcs: Dict[int, Tuple[float, float, float]], penalty: float,
                 newton: NewtonOptions, group: ShardGroup, device=None,
                 ops: Ops = KERNEL_OPS):
        self.mesh = mesh
        self.newton = newton
        self.penalty = float(penalty)
        self.group = group
        self.ops = ops
        self.device = (group.devices[0] if device is None
                       else torch.device(device))
        self.plan, self._layout = plan_blocks(mesh, group.D)
        mats = dict(zip(_MATERIALS, (young, poisson, fibre_k, rates,
                                     fibres)))
        # the mesh's element blocks (a single-type mesh is its one block)
        blocks = mesh.blocks if mesh.elem_type == "MIXED" else [mesh]
        starts = np.cumsum([0] + [b.n_elems for b in blocks])
        # per block: each element's shard and column in it
        where = []
        for b in self._layout:
            pos = np.empty(len(b.ids), dtype=np.int64)
            pos[b.ids] = np.arange(len(b.ids))
            off = np.concatenate([[0], np.cumsum(b.counts)])
            shard = np.searchsorted(off, pos, side="right") - 1
            where.append((shard, pos - off[shard]))
        # penalty faces on their parent element's shard, grouped by type
        recs: Dict[str, List[tuple]] = {}
        bid_all = np.asarray(mesh.boundary_id)
        for bid, disp in bcs.items():
            d = np.asarray(disp, dtype=np.float64)
            m, dv = (~np.isnan(d)).astype(np.float64), np.nan_to_num(d)
            for fi in np.nonzero(bid_all == bid)[0]:
                bi = (int(mesh.boundary_block[fi])
                      if mesh.elem_type == "MIXED" else 0)
                e = int(mesh.boundary_elem[fi])
                ks = list(ELEMENT_FACES[self._layout[bi].elem_type][
                    int(mesh.boundary_side[fi])])
                s, col = int(where[bi][0][e]), int(where[bi][1][e])
                slots = self._layout[bi].conn_local[s][ks, col]
                x0 = mesh.coords[np.asarray(blocks[bi].connectivity)[e, ks]]
                recs.setdefault(_face_type(mesh, len(ks)), []).append(
                    (s, slots, x0, m, dv))
        self.face_types = sorted(recs)
        self.shards = self._make_shards(blocks, mats, starts, recs)

    def _make_shards(self, mesh_blocks, mats, starts, recs
                     ) -> List[_SolidShard]:
        plan = self.plan
        Nloc = plan.No_max + plan.Gtot
        shards = []
        for s, dev in enumerate(self.group.devices):
            f64 = lambda a: torch.tensor(np.ascontiguousarray(a),
                                         dtype=torch.float64, device=dev)
            idx = lambda a: torch.tensor(np.ascontiguousarray(a),
                                         device=dev)
            blocks, conns = [], []
            for bi, b in enumerate(self._layout):
                if int(b.counts[s]) == 0:
                    continue  # no element of this block: nothing to launch
                conn = b.shard_conn(s)
                conns.append(conn)
                ids = b.shard_ids(s)
                gconn = np.asarray(mesh_blocks[bi].connectivity)[ids]
                tb = {k: f64(np.asarray(v)[starts[bi] + ids])
                      for k, v in mats.items()}
                tb["X0e_cf"] = f64(np.transpose(self.mesh.coords[gconn],
                                                (1, 2, 0)))
                blocks.append({"elem_type": b.elem_type,
                               "block": ElementBlock(b.elem_type, conn, dev),
                               "conn": idx(conn.astype(np.int64)),
                               "tables": tb})
            faces = []
            for ft in self.face_types:
                mine = [r for r in recs[ft] if r[0] == s]
                if not mine:
                    continue
                fc = np.stack([r[1] for r in mine]).astype(np.int64)
                faces.append({
                    "face_type": ft, "conn": idx(fc),
                    "X0f": f64(np.stack([r[2] for r in mine])),
                    "mask": f64(np.stack([r[3] for r in mine])),
                    "disp": f64(np.stack([r[4] for r in mine])),
                    # the (Kf, F_s) k-major face corners onto local slots
                    "fgather": idx(invert_scatter(fc.T.reshape(-1), Nloc)),
                })
            mask = np.zeros(plan.No_max)
            mask[: plan.owned_counts[s]] = 1.0
            shards.append(_SolidShard(
                dev, blocks,
                idx(block_node_gather(conns, Nloc)) if conns else None,
                faces, [idx(t[s].astype(np.int64)) for t in plan.send_idx],
                idx(plan.rev_gather[s]), f64(mask)))
        return shards

    # ------------------------------------------------------------------
    # shard stages
    # ------------------------------------------------------------------
    def _face_terms(self, fg: dict, xg: torch.Tensor, pt: torch.Tensor):
        """A face group's penalty residual Rf (3, Kf, F_s) and Jacobian
        pen (Kf, Kf, F_s) at the ghost-filled positions xg (3, Nloc)
        (src/solid_system.C:273-371; the Jacobian keeps only the penalty
        psi_i psi_j blocks, the reference's inexact linearization)."""
        ratio = pt * 1.000001
        psi, JxWf, xyz, _ = face_geometry_factors(xg.T, fg["conn"],
                                                  fg["face_type"])
        orig = torch.einsum("qk,fkd->fqd", psi, fg["X0f"])
        diff = xyz - orig - (ratio * fg["disp"])[:, None, :]
        masked = diff * fg["mask"][:, None, :]
        Rf = self.penalty * torch.einsum("fq,qi,fqv->vif", JxWf, psi,
                                         masked)
        pen = self.penalty * torch.einsum("fq,qi,qj->ijf", JxWf, psi, psi)
        return Rf, pen

    def _elements(self, sh: _SolidShard, xg: torch.Tensor, pt,
                  want_tangent: bool):
        """Each block's (Fe (3, K, E_s), Ke (3, 3, K, K, E_s) or None)."""
        from ..systems.solid import element_kernels_cf

        x = xg.T
        return [element_kernels_cf(
            b["elem_type"], x, b["conn"], b["tables"]["X0e_cf"],
            b["tables"]["young"], b["tables"]["poisson"],
            b["tables"]["fibre_k"], b["tables"]["rates"],
            b["tables"]["fibres"], pt, want_tangent=want_tangent)
            for b in sh.blocks]

    def _faces_onto(self, sh: _SolidShard, parts: Sequence[torch.Tensor],
                    W: int, y: torch.Tensor) -> torch.Tensor:
        """y plus each face group's (W, Kf, F_s) values, K4 over its
        fgather."""
        for fg, p in zip(sh.faces, parts):
            y = y + self.ops.restrict(p.reshape(W, -1).contiguous(),
                                      fg["fgather"])
        return y

    def _residual_local(self, sh, FKs, Rfs):
        """The local residual (3, Nloc): elements, then the face groups."""
        y = self._restrict_onto(sh.node_gather, [Fe for Fe, _ in FKs], 3,
                                sh.device)
        return self._faces_onto(sh, Rfs, 3, y)

    def _norm(self, R: Sequence[torch.Tensor]) -> float:
        """|R| over the owned slots of every shard."""
        return float(torch.sqrt(self.group.psum(
            [((r * sh.mask) ** 2).sum() for r, sh in zip(R, self.shards)])))

    @staticmethod
    def _pt(pseudo_time: float, sh: _SolidShard) -> torch.Tensor:
        return torch.tensor(float(pseudo_time), dtype=torch.float64,
                            device=sh.device)

    def assemble(self, x: Sequence[torch.Tensor], pseudo_time: float):
        """At the slabs x (3, No_max): (R, each shard's batched Ke per
        block and pen per face group, Dinv, |R|), R and Dinv per shard
        (3, No_max) and (3, 3, No_max) (the reference's
        _assemble_shard)."""
        xg = self.ghost_fill(x)
        Rl, dl, KeBs, pens = [], [], [], []
        for sh, xs in zip(self.shards, xg):
            pt = self._pt(pseudo_time, sh)
            FKs = self._elements(sh, xs, pt, True)
            ft = [self._face_terms(fg, xs, pt) for fg in sh.faces]
            Rl.append(self._residual_local(sh, FKs, [Rf for Rf, _ in ft]))
            # the element diagonal blocks Ke[:, :, i, i] (3, 3, K, E_s)
            d = self._restrict_onto(sh.node_gather, [
                torch.diagonal(Ke, dim1=2, dim2=3).transpose(2, 3)
                for _, Ke in FKs], 9, sh.device)
            eye = torch.eye(3, dtype=torch.float64, device=sh.device)
            # the face diagonal: delta_vw mask_v pen[i, i]
            dl.append(self._faces_onto(sh, [
                eye[:, :, None, None] * fg["mask"].T[:, None, None, :]
                * torch.diagonal(pen).T[None, None]
                for fg, (_, pen) in zip(sh.faces, ft)], 9, d))
            KeBs.append([ElementBlock.batched(Ke) for _, Ke in FKs])
            pens.append([pen for _, pen in ft])
            del FKs
        R = self.reverse_add(Rl)
        Dinv = []
        for dg in self.reverse_add(dl):
            dg = dg.reshape(3, 3, -1)
            # empty rows (pad slots) get an identity block
            empty = dg.abs().sum(dim=(0, 1)) == 0.0
            eye = torch.eye(3, dtype=dg.dtype, device=dg.device)
            dg = torch.where(empty[None, None, :], eye[:, :, None], dg)
            Dinv.append(small_block_inverse(dg, pivot=False))
        return R, KeBs, pens, Dinv, self._norm(R)

    def residual_norm(self, x: Sequence[torch.Tensor],
                      pseudo_time: float) -> float:
        """|R| only, without the tangent (the line-search trials; the
        reference's _residual_shard)."""
        xg = self.ghost_fill(x)
        Rl = []
        for sh, xs in zip(self.shards, xg):
            pt = self._pt(pseudo_time, sh)
            FKs = self._elements(sh, xs, pt, False)
            Rfs = [self._face_terms(fg, xs, pt)[0] for fg in sh.faces]
            Rl.append(self._residual_local(sh, FKs, Rfs))
        return self._norm(self.reverse_add(Rl))

    def solve_linear(self, KeBs, pens, Dinv, R, rtol: float):
        """K dx = -R by the distributed BiCGStab on the block-Jacobi
        preconditioned shard operator, from dx = 0 (the reference's
        _solve_shard).  Returns (dx slabs, iterations, |r| / |b|)."""
        masks = [sh.mask for sh in self.shards]

        def matvec(p):
            pg = self.ghost_fill(p)
            yl = []
            for sh, xs, KB, pen in zip(self.shards, pg, KeBs, pens):
                y = self._restrict_onto(sh.node_gather, [
                    b["block"].dense_apply(K_, xs)
                    for b, K_ in zip(sh.blocks, KB)], 3, sh.device)
                yl.append(self._faces_onto(sh, [
                    torch.einsum("ijf,vjf->vif", pn, xs[:, fg["conn"].T])
                    * fg["mask"].T[:, None, :]
                    for fg, pn in zip(sh.faces, pen)], 3, y))
            return self.reverse_add(yl)

        pre_matvec = lambda p: [apply_block_jacobi(di, y)
                                for di, y in zip(Dinv, matvec(p))]
        pre_b = [apply_block_jacobi(di, -r) * m
                 for di, r, m in zip(Dinv, R, masks)]
        x0 = [torch.zeros_like(b) for b in pre_b]
        x, iters, res = _bicgstab_dist(pre_matvec, pre_b, x0, masks,
                                       self.group, rtol,
                                       self.newton.max_linear_iterations)
        return [xs * m for xs, m in zip(x, masks)], iters, res

    @staticmethod
    def _length(x: Sequence[torch.Tensor]) -> float:
        """|x| over the shards (pad slots hold zeros)."""
        return float(np.sqrt(sum(float((xs * xs).sum()) for xs in x)))

    # ------------------------------------------------------------------
    def run_solver(self, x_global, pseudo_time: float) -> NewtonResult:
        """One load step: the distributed Newton to equilibrium from the
        global positions (N, 3), with the reference's stopping rules and
        residual-only line-search trials (its run_solver, rdcfes_tpu/
        parallel/solid_halo.py:658-714).  The result's x is (N, 3) on
        `device`."""
        opts = self.newton
        pt = float(pseudo_time)
        x_host = (x_global.detach().cpu().numpy()
                  if torch.is_tensor(x_global) else np.asarray(x_global))
        x = self.scatter_nodal(x_host)
        R, KeBs, pens, Dinv, rnorm = self.assemble(x, pt)
        r0 = rnorm if rnorm > 0 else 1.0
        k, lin_total, converged = 0, 0, False
        while k < opts.max_nonlinear_iterations:
            if rnorm <= opts.absolute_residual_tolerance:
                converged = True
                break
            if rnorm / r0 <= opts.relative_residual_tolerance:
                converged = True
                break
            lin_rtol = max(min(opts.initial_linear_tolerance, rnorm / r0),
                           1e-14)
            dx, lin_iters, lin_res = self.solve_linear(KeBs, pens, Dinv, R,
                                                       lin_rtol)
            lin_total += int(lin_iters)
            lam = 1.0
            if not all(bool(torch.isfinite(d.sum())) for d in dx):
                break
            need_ls = (float(lin_res) > 1.0
                       and not opts.require_residual_reduction)
            if need_ls or opts.require_residual_reduction:
                reduced = False
                for _ in range(opts.max_line_search_steps):
                    trial = [xs + lam * d for xs, d in zip(x, dx)]
                    if self.residual_norm(trial, pt) < rnorm:
                        reduced = True
                        break
                    lam *= 0.5
                if not reduced:
                    break
            x = [xs + lam * d for xs, d in zip(x, dx)]
            del KeBs, pens
            R, KeBs, pens, Dinv, rnorm = self.assemble(x, pt)
            k += 1
            xnorm = self._length(x)
            step_rel = lam * self._length(dx) / (xnorm or 1.0)
            if step_rel <= opts.relative_step_tolerance:
                converged = True
                break
        else:
            converged = (rnorm <= opts.absolute_residual_tolerance
                         or rnorm / r0 <= opts.relative_residual_tolerance)
        return NewtonResult(
            x=torch.as_tensor(self.gather(x), device=self.device), iters=k,
            residual_norm=rnorm, initial_residual_norm=r0,
            converged=converged, linear_iters=lin_total)
