"""Host sparsity/gather tables (NumPy) and the element <-> node transfers
(torch).

Host side (NumPy copies of rdcfes_tpu.fem.assembly, bit-identical output):
the node-pair sparsity, its ELLPACK view, and its inversion into padded
gather tables so every element -> node (or node-pair) sum is a
deterministic gather-sum.

Device side (torch, channel-first): `interpolate_ue` (corner values ->
quadrature values and per-q gradients of any element) and
`interpolate_at_qp` (the same from nodal values),
`interpolate_ue_affine` (the same with the q-independent gradient of an
affine element), `restrict` (the gather-sum through a padded table), and the solid path's
`assemble_matrix_gather` / `assemble_vector_gather`, which are `restrict`
on the flattened element matrices / vectors.  The CUDA kernels of
fem/kernels.py compute the same functions; these are their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class NodePairSparsity(NamedTuple):
    """Host-precomputed block-CSR structure over node pairs.

    n_nodes   : int
    nnz       : int                   number of node-pair blocks
    rows      : (nnz,) int32          row (node) id of each block
    cols      : (nnz,) int32          col (node) id of each block
    slots     : (E, K, K) int32       nonzero index of (element, i, j)
    row_ptr   : (n_nodes+1,) int64    CSR offsets (blocks sorted by row, col)
    diag_slots: (n_nodes,) int32      slot of each diagonal block
    """

    n_nodes: int
    nnz: int
    rows: np.ndarray
    cols: np.ndarray
    slots: np.ndarray
    row_ptr: np.ndarray
    diag_slots: np.ndarray

    def slots_flat_cf(self) -> np.ndarray:
        """Slot ids flattened in (i, j, e) order (channel-first Ke)."""
        return np.ascontiguousarray(
            np.transpose(self.slots, (1, 2, 0))).reshape(-1)


def build_sparsity(connectivity: np.ndarray, n_nodes: int) -> NodePairSparsity:
    """Node-pair block sparsity + per-element slot table (the reference's
    NumPy path; its native meshkit path gives the same arrays)."""
    conn = np.asarray(connectivity, dtype=np.int64)
    E, K = conn.shape
    rows = np.repeat(conn, K, axis=1).reshape(E, K, K)  # rows[e,i,j] = conn[e,i]
    cols = np.tile(conn, (1, K)).reshape(E, K, K)       # cols[e,i,j] = conn[e,j]
    pair_keys = rows.reshape(-1) * np.int64(n_nodes) + cols.reshape(-1)
    uniq, inv = np.unique(pair_keys, return_inverse=True)
    nnz = uniq.shape[0]
    u_rows = (uniq // n_nodes).astype(np.int32)
    u_cols = (uniq % n_nodes).astype(np.int32)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(row_ptr, u_rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    diag = np.nonzero(u_rows == u_cols)[0]
    diag_slots = np.full(n_nodes, -1, dtype=np.int32)
    diag_slots[u_rows[diag]] = diag.astype(np.int32)
    return NodePairSparsity(
        n_nodes=n_nodes, nnz=nnz, rows=u_rows, cols=u_cols,
        slots=inv.reshape(E, K, K).astype(np.int32), row_ptr=row_ptr,
        diag_slots=diag_slots,
    )


def ell_structure(sp: NodePairSparsity) -> Tuple[np.ndarray, np.ndarray]:
    """ELLPACK view of the block-CSR sparsity: per-row padded column/slot
    tables in channel-first layout, (ell_cols [L, N], ell_slot [L, N])
    int32 with L the largest row degree; padding entries carry column 0
    and slot == nnz (callers append one zero block at index nnz)."""
    N = sp.n_nodes
    deg = np.diff(sp.row_ptr)
    L = int(deg.max())
    ar = np.arange(sp.nnz, dtype=np.int64)
    pos = ar - sp.row_ptr[sp.rows]
    ell_cols = np.zeros((L, N), dtype=np.int32)
    ell_slot = np.full((L, N), sp.nnz, dtype=np.int32)
    ell_cols[pos, sp.rows] = sp.cols
    ell_slot[pos, sp.rows] = ar.astype(np.int32)
    return ell_cols, ell_slot


def gather_tables(sp: NodePairSparsity, connectivity: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Invert the scatter maps into padded gather tables.

    slot_gather : (C, nnz) int32 indices into the flat (i, j, e)-ordered
                  element-matrix buffer; padding = K*K*E
    node_gather : (C2, n_nodes) int32 indices into the flat (k, e)-ordered
                  element-vector buffer; padding = K*E
    """
    conn = np.asarray(connectivity)
    slot_gather = invert_scatter(sp.slots_flat_cf().astype(np.int64), sp.nnz)
    node_gather = invert_scatter(conn.T.reshape(-1).astype(np.int64),
                                 sp.n_nodes)
    return slot_gather, node_gather


def invert_scatter(targets: np.ndarray, n_bins: int) -> np.ndarray:
    """Row c of the result holds, for each bin, the index of its c-th
    contribution in the flat source buffer (stable order); padding =
    len(targets)."""
    targets = np.asarray(targets, dtype=np.int64)
    order = np.argsort(targets, kind="stable")
    sorted_t = targets[order]
    counts = np.bincount(sorted_t, minlength=n_bins)
    C = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((C, n_bins), len(targets), dtype=np.int64)
    pos = np.arange(len(targets)) - starts[sorted_t]
    table[pos, sorted_t] = order
    return table.astype(np.int32)


def interpolate_ue(ue: torch.Tensor, phi: np.ndarray, dphi: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner values ue (V, K, E) -> (x_qp (V, Q, E), gx_qp (V, Q, 3, E))
    with per-q shape gradients dphi (Q, K, 3, E): the generic
    (non-affine) interpolation.

    The corner sum runs k = 0..K-1 in order, as the reference's; each term
    is one broadcast product over the (V, Q) or (V, Q, 3) axes, so the op
    count is 4 K whatever the element.  phi (Q, K) is a host table, cast
    to ue's dtype."""
    K = phi.shape[1]
    ph = torch.as_tensor(np.asarray(phi), dtype=ue.dtype, device=ue.device)
    x_qp = ph[None, :, 0, None] * ue[:, None, 0, :]
    gx_qp = dphi[None, :, 0] * ue[:, None, None, 0, :]
    for k in range(1, K):
        x_qp = x_qp + ph[None, :, k, None] * ue[:, None, k, :]
        gx_qp = gx_qp + dphi[None, :, k] * ue[:, None, None, k, :]
    return x_qp, gx_qp


def interpolate_at_qp(u: torch.Tensor, conn_T: torch.Tensor, phi: np.ndarray,
                      dphi: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nodal fields u (V, N) -> (u_qp (V, Q, E), grad_qp (V, Q, 3, E)):
    the corner gather through conn_T (K, E), then `interpolate_ue`
    (rdcfes_tpu.fem.assembly.interpolate_at_qp; the ADPM driver's
    element averages, src/adpm.C:765-781)."""
    return interpolate_ue(u[:, conn_T], phi, dphi)


def interpolate_ue_affine(ue: torch.Tensor, phi: np.ndarray,
                          dphi: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner values ue (V, K, E) -> (x_qp (V, Q, E), gx (V, 3, E)) for an
    AFFINE element: the gradient is q-independent and taken from dphi[0].

    phi (Q, K) is a host table whose entries multiply as Python floats, so
    an f32 ue stays f32; dphi is (Q, K, 3, E) or its q-slice (K, 3, E)."""
    Q, K = phi.shape
    dphi0 = dphi[0] if dphi.dim() == 4 else dphi
    uq = []
    for q in range(Q):
        acc = float(phi[q, 0]) * ue[:, 0, :]
        for k in range(1, K):
            acc = acc + float(phi[q, k]) * ue[:, k, :]
        uq.append(acc)
    dirs = []
    for d in range(3):
        acc = dphi0[0, d] * ue[:, 0, :]
        for k in range(1, K):
            acc = acc + dphi0[k, d] * ue[:, k, :]
        dirs.append(acc)
    return torch.stack(uq, dim=1), torch.stack(dirs, dim=1)


def restrict(flat: torch.Tensor, node_gather: torch.Tensor) -> torch.Tensor:
    """(W, K*E) element-corner values -> (W, N) nodal sums through the
    padded node_gather table (C, N): c = 0..C-1 summed in order, the pad
    index K*E reading an appended zero (the reference's _restrict and
    _diag_blocks, systems/transient.py:584-593, :488-502)."""
    pad = torch.zeros(flat.shape[:-1] + (1,), dtype=flat.dtype,
                      device=flat.device)
    f = torch.cat([flat, pad], dim=-1)
    acc = f[..., node_gather[0]]
    for c in range(1, node_gather.shape[0]):
        acc = acc + f[..., node_gather[c]]
    return acc


def assemble_matrix_gather(Ke: torch.Tensor, slot_gather: torch.Tensor,
                           restrict_op=restrict) -> torch.Tensor:
    """Block values (V, W, nnz) from element matrices Ke (V, W, K, K, E)
    through slot_gather (C, nnz) (pad K*K*E): the restriction of the flat
    (V*W, K*K*E) buffer.  restrict_op is `restrict` or the kernel K4."""
    V, W = Ke.shape[:2]
    return restrict_op(Ke.reshape(V * W, -1), slot_gather).reshape(V, W, -1)


def assemble_vector_gather(Fe: torch.Tensor, node_gather: torch.Tensor,
                           restrict_op=restrict) -> torch.Tensor:
    """Nodal vector (V, N) from element vectors Fe (V, K, E) through
    node_gather (C, N) (pad K*E)."""
    return restrict_op(Fe.reshape(Fe.shape[0], -1), node_gather)
