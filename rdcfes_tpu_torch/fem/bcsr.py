"""Block-sparse operators in channel-first layout (torch port of
rdcfes_tpu.fem.bcsr).

`bcsr_matvec` is the CSR matvec outside the Krylov loops: the per-slot
products gathered onto their rows by an ordered gather-sum (K4 on the
card) through the rows' inverted scatter table, where the reference
scatter-adds; `bcsr_matvec_gather` takes that table made once, as
solvers.krylov.solve_bcsr does for its loop.

Block values (V, W, nnz) over the node-pair sparsity are re-laid into
ELLPACK (V, W, L, N) once per linear solve; the SpMV inside the Krylov loop
is then a gather of x through the column table and a reduction over (w, l)
(`ell_matvec`, the plain version of the CUDA kernel K5 in fem/kernels.py).
The reference's Beneš-routed `ell_matvec_fast` has no counterpart: it
existed because gathers were slow on the TPU.
"""

from __future__ import annotations

import torch

from .assembly import k4_restrict, scatter_table


def bcsr_matvec(values: torch.Tensor, rows, cols, x: torch.Tensor,
                n_nodes: int, ops=None) -> torch.Tensor:
    """y = A @ x with A in channel-first block CSR: values (V, W, nnz),
    rows / cols (nnz,) (arrays or tensors), x (W, n_nodes) -> y (V,
    n_nodes).  y[v, n] sums the slots of row n in slot order, through
    the rows' table made here (fem.assembly.scatter_table)."""
    return bcsr_matvec_gather(values, cols, x,
                              scatter_table(rows, n_nodes, x.device), ops)


def bcsr_matvec_gather(values: torch.Tensor, cols, x: torch.Tensor,
                       row_gather: torch.Tensor, ops=None) -> torch.Tensor:
    """bcsr_matvec with the rows' table row_gather (C, n_nodes) made once
    by the caller: ops.restrict (fem.kernels.KERNEL_OPS by default) sums
    the per-slot products onto their rows."""
    cols = torch.as_tensor(cols, device=x.device).long()  # no copy if so
    prod = torch.einsum("vws,ws->vs", values, x[:, cols])
    return k4_restrict(ops)(prod.contiguous(), row_gather)


def extract_diagonal_blocks(values: torch.Tensor,
                            diag_slots: torch.Tensor) -> torch.Tensor:
    """The (V, V, N) diagonal blocks, for block-Jacobi."""
    return values[:, :, diag_slots]


def to_ell(values: torch.Tensor, ell_slot: torch.Tensor) -> torch.Tensor:
    """Block values (V, W, nnz) -> ELLPACK (V, W, L, N); padding slots
    (== nnz) read an appended zero block."""
    V, W, _ = values.shape
    pad = torch.zeros((V, W, 1), dtype=values.dtype, device=values.device)
    return torch.cat([values, pad], dim=-1)[:, :, ell_slot]


def ell_matvec(values_ell: torch.Tensor, ell_cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in ELLPACK block layout: values_ell (V, W, L, N), ell_cols
    (L, N), x (W, N) -> y (V, N), y[v, n] = sum_{w, l} values_ell[v, w, l, n]
    * x[w, ell_cols[l, n]]."""
    xg = x[:, ell_cols]  # (W, L, N)
    return torch.sum(values_ell * xg[None], dim=(1, 2))
