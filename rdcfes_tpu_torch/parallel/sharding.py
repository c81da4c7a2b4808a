"""The replicated-iterate multi-device transient system (the port of
rdcfes_tpu/parallel/sharding.py, the reference's first multi-device
design, which its halo system, parallel/halo.py, later replaced on every
driver path).

Layout, built once on the host in NumPy (the reference's tables, bit for
bit):

  * the elements are split into D contiguous blocks of Eb =
    ceil(E / D) in mesh order, the last padded with elements of
    connectivity 0, JxW 0 and dphi 0 (`partition_elements`);
  * each shard has a (C, N) restriction table over the global nodes: row
    c holds, for each node, the flat (k, e_local) index of its c-th
    corner on the shard (a stable argsort, so in mesh order), pad K Eb;
    padded elements contribute nothing.

Every vector is global and replicated: the state u (N, V), the Krylov
iterate and its dot products live on shard 0's device, and each shard
reads them whole.  Per step, on every shard (the reference's
_step_shard): the gather and interpolation of u through ElementBlock.interp
(K1 on TET4 and TRI3, K8 on the other types), the dense `physics`
WeakForm, element_vectors and element_matrices (plain torch, as the
reference leaves them to XLA), then K4 restricts Fe and the diagonal
blocks onto the shard's partial (V, N) and (V V, N).  The reference's
psum becomes ShardGroup.psum: the shards' partials added in shard order
on shard 0's device.  Every matvec gathers x through the shard's
connectivity, applies its element matrices by one batched product (XLA
in the reference too) and restricts with K4, then the partials are
summed the same way.  The solve is solvers.krylov.bicgstab (the
reference's _bicgstab is the same recurrence) on the system
left-preconditioned by the block-Jacobi inverse of the summed diagonal
(empty rows get an identity block); its dots read the replicated iterate
on shard 0's device and need no collective.

The reference pads dphi to 3 components, which its 2D geometry already
has (the third is zero), so TRI3 and QUAD4/8/9 meshes run here as there;
a MixedMesh raises ValueError: the reference reads one connectivity and
one element type.

A CUDA placement runs the D shards one after another on one card, or on
D cards when D are present (parallel.halo.shard_devices).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..fem.geometry import geometry_factors
from ..fem.kernels import KERNEL_OPS, Ops
from ..fem.weakform import element_matrices, element_vectors
from ..solvers.krylov import (DEFAULT_MAXITER, DEFAULT_RTOL,
                              apply_block_jacobi, bicgstab,
                              small_block_inverse)
from ..systems.transient import (_ELEMENT_TYPES, ElementBlock, Geometry,
                                 clamp_nonnegative)
from .halo import ShardGroup, shard_devices


def partition_elements(n_elems: int, n_shards: int) -> Tuple[int, int]:
    """Contiguous equal-size blocks; returns (padded_count, block)."""
    block = -(-n_elems // n_shards)
    return block * n_shards, block


class _Shard(NamedTuple):
    """One shard's elements on its device: the ElementBlock over its
    padded (K, Eb) connectivity, its Geometry (dphi one gradient per
    element on the affine types) and its K4 table (C, N) int32."""
    device: torch.device
    blk: ElementBlock
    geom: Geometry
    node_gather: torch.Tensor


class ShardedTransientSystem:
    """Element-sharded linearized-CN transient system: the reference's
    ShardedTransientSystem, its device mesh replaced by the shard count
    and a placement.

    mesh      : a single-type Mesh of a type TransientRDCSystem takes
                (TET4, HEX8, TET10, HEX20, HEX27, TRI3, QUAD4, QUAD8,
                QUAD9)
    n_vars    : number of coupled nodal variables V
    physics   : the dense WeakForm callable (models.*_physics)
    n_shards  : D
    clamp, rtol, maxiter : as the reference's (f64 BiCGStab)
    device    : the placement (parallel.halo.shard_devices): None the
                card
    ops       : fem.kernels.KERNEL_OPS (default) or PLAIN_OPS

    Host tables (NumPy, the reference's arrays): conn_T (K, Epad) int32,
    JxW (Q, Epad), dphi (Q, K, 3, Epad), node_gather (D, C, N) int32."""

    def __init__(self, mesh, n_vars: int, physics: Callable,
                 n_shards: int, clamp: Callable = clamp_nonnegative,
                 rtol: float = DEFAULT_RTOL,
                 maxiter: int = DEFAULT_MAXITER, device=None,
                 ops: Ops = KERNEL_OPS):
        if mesh.elem_type == "MIXED":
            raise ValueError("a MixedMesh in ShardedTransientSystem: the "
                             "reference's reads one connectivity and one "
                             "elem_type (parallel.halo.HaloShardedSystem "
                             "takes a MixedMesh)")
        if mesh.elem_type not in _ELEMENT_TYPES:
            raise ValueError(f"{mesh.elem_type} meshes in "
                             f"ShardedTransientSystem")
        self.mesh = mesh
        self.n_vars = n_vars
        self.physics = physics
        self.clamp = clamp
        self.rtol = rtol
        self.maxiter = maxiter
        self.ops = ops
        self.group = ShardGroup(shard_devices(int(n_shards), device))
        self.device = self.group.devices[0]
        D = self.n_shards = self.group.D
        N, E, K = mesh.n_nodes, mesh.n_elems, mesh.nodes_per_elem

        # ---- element tables, padded to D equal blocks --------------------
        Epad, Eb = partition_elements(E, D)
        self.Eb = Eb
        conn = np.asarray(mesh.connectivity)
        conn_T = np.zeros((K, Epad), dtype=np.int32)
        conn_T[:, :E] = conn.T
        phi, JxW, dphi = geometry_factors(
            torch.as_tensor(np.asarray(mesh.coords, dtype=np.float64)),
            torch.as_tensor(conn), mesh.elem_type)
        Q = JxW.shape[0]
        JxW_p = np.zeros((Q, Epad))
        JxW_p[:, :E] = JxW.numpy()  # padded elements weigh zero
        dphi_p = np.zeros((Q, K, 3, Epad))
        dphi_p[..., :E] = dphi.numpy()
        self.phi = phi
        self.conn_T, self.JxW, self.dphi = conn_T, JxW_p, dphi_p
        self.node_gather = _restriction_tables(conn_T, E, N, D, Eb)

        self.shards: List[_Shard] = []
        for s, dev in enumerate(self.group.devices):
            sl = slice(s * Eb, (s + 1) * Eb)
            blk = ElementBlock(mesh.elem_type, conn_T[:, sl].T, dev)
            dp = dphi_p[..., sl]
            dp = dp[0] if blk.affine else dp  # one gradient per element
            jw = torch.tensor(np.ascontiguousarray(JxW_p[:, sl]),
                              device=dev)
            dp = torch.tensor(np.ascontiguousarray(dp), device=dev)
            # the dense step reads no f32 cast: the f64 tables stand in
            self.shards.append(_Shard(
                dev, blk, Geometry(jw, dp, jw, dp),
                torch.tensor(self.node_gather[s], device=dev)))

    # ------------------------------------------------------------------
    def initial_state(self, u0) -> torch.Tensor:
        """u0 (N, V) -> an f64 tensor on shard 0's device."""
        u0 = np.asarray(u0, dtype=np.float64)
        if u0.shape != (self.mesh.n_nodes, self.n_vars):
            raise ValueError(f"u0 shape {u0.shape}, expected "
                             f"{(self.mesh.n_nodes, self.n_vars)}")
        return torch.tensor(u0, device=self.device)

    # ------------------------------------------------------------------
    def element_kernels(self, s: int, u_T: torch.Tensor, fields: Dict,
                        params: Dict):
        """Shard s's (Fe (V, K, Eb), Ke (V, V, K, K, Eb), diag_e (V, V, K,
        Eb)) at the replicated u_T (V, N): the gather and interpolation,
        the physics and the dense element integrals."""
        sh = self.shards[s]
        blk, g = sh.blk, sh.geom
        u_qp, grad_qp = blk.interp(self.ops, u_T.to(sh.device), g)
        wf = self.physics(u_qp, grad_qp, fields, params)
        dphi = g.dphi
        if blk.affine:  # the reference's (Q, K, 3, E) table
            dphi = dphi[None].expand((len(blk.phi),) + dphi.shape)
        Fe = element_vectors(wf, blk.phi, g.JxW, dphi)
        Ke, diag_e = element_matrices(
            wf, blk.phi, g.JxW, dphi,
            grad_const=self.mesh.elem_type == "TET4", return_diag=True)
        return Fe, Ke, diag_e

    def _element_stage(self, u_T: torch.Tensor, fields: Dict,
                       params: Dict):
        """Each shard's (partial b (V, N), partial diagonal (V V, N),
        batched element matrices (Eb, V K, V K)) at the replicated
        u_T (V, N)."""
        V, ops = self.n_vars, self.ops
        out = []
        for s, sh in enumerate(self.shards):
            Fe, Ke, diag_e = self.element_kernels(s, u_T, fields, params)
            b = ops.restrict(Fe.reshape(V, -1).contiguous(), sh.node_gather)
            d = ops.restrict(diag_e.reshape(V * V, -1).contiguous(),
                             sh.node_gather)
            out.append((b, d, ElementBlock.batched(Ke)))
            del Ke, diag_e
        return out

    def _matvec(self, x: torch.Tensor, KeBs) -> torch.Tensor:
        """psum over the shards of K4(Ke x[:, conn]) for x (V, N)."""
        V = self.n_vars
        parts = []
        for sh, KB in zip(self.shards, KeBs):
            ye = sh.blk.dense_apply(KB, x.to(sh.device))
            parts.append(self.ops.restrict(ye.reshape(V, -1).contiguous(),
                                           sh.node_gather))
        return self.group.psum(parts)

    def step(self, u: torch.Tensor, fields: Optional[Dict] = None,
             params: Optional[Dict] = None):
        """One step from u (N, V) on shard 0's device; `fields` and
        `params` go unchanged to every shard's physics.  Returns (u_new
        (N, V) clamped, iterations, |r| / |b| 0-d)."""
        V, N = self.n_vars, self.mesh.n_nodes
        u_T = u.T.contiguous()
        stage = self._element_stage(u_T, fields or {}, params or {})
        b = self.group.psum([x for x, _, _ in stage])
        diag = self.group.psum([d for _, d, _ in stage]).reshape(V, V, N)
        KeBs = [KB for _, _, KB in stage]
        del stage
        # block-Jacobi from the summed diagonal; empty rows the identity
        empty = diag.abs().sum(dim=(0, 1)) == 0.0
        eye = torch.eye(V, dtype=diag.dtype, device=diag.device)
        diag = torch.where(empty[None, None, :], eye[:, :, None], diag)
        Dinv = small_block_inverse(diag, pivot=False)

        # left-preconditioned BiCGStab on the preconditioned residual
        pre_matvec = lambda x: apply_block_jacobi(Dinv,
                                                  self._matvec(x, KeBs))
        pre_b = apply_block_jacobi(Dinv, b)
        x, iters, res = bicgstab(pre_matvec, pre_b, x0=u_T, rtol=self.rtol,
                                 maxiter=self.maxiter)
        return self.clamp(x).T, iters, res


def _restriction_tables(conn_T: np.ndarray, n_elems: int, n_nodes: int,
                        D: int, Eb: int) -> np.ndarray:
    """node_gather (D, Cmax, N) int32: node_gather[s, c, n] is the flat
    (k, e_local) index of the c-th element-corner contribution to node n
    on shard s, pad K Eb; padded elements contribute nothing (the
    reference's tables, rdcfes_tpu/parallel/sharding.py:104-128)."""
    K = conn_T.shape[0]
    tables, Cmax = [], 1
    for s in range(D):
        local = conn_T[:, s * Eb:(s + 1) * Eb].reshape(-1)
        e_ids = np.tile(np.arange(s * Eb, (s + 1) * Eb), (K, 1)).reshape(-1)
        valid = np.nonzero(e_ids < n_elems)[0]
        order = valid[np.argsort(local[valid], kind="stable")]
        sorted_nodes = local[order]
        counts = np.bincount(sorted_nodes, minlength=n_nodes)
        Cs = int(counts.max()) if len(sorted_nodes) else 1
        Cmax = max(Cmax, Cs)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        tbl = np.full((Cs, n_nodes), K * Eb, dtype=np.int32)
        pos = np.arange(len(sorted_nodes)) - starts[sorted_nodes]
        tbl[pos, sorted_nodes] = order
        tables.append(tbl)
    node_gather = np.full((D, Cmax, n_nodes), K * Eb, dtype=np.int32)
    for s, tbl in enumerate(tables):
        node_gather[s, :tbl.shape[0]] = tbl
    return node_gather

