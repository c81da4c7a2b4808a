"""Block-sparse operators in channel-first layout (torch port of
rdcfes_tpu.fem.bcsr).

Block values (V, W, nnz) over the node-pair sparsity are re-laid into
ELLPACK (V, W, L, N) once per linear solve; the SpMV inside the Krylov loop
is then a gather of x through the column table and a reduction over (w, l)
(`ell_matvec`, the plain version of the CUDA kernel K5 in fem/kernels.py).
The reference's Beneš-routed `ell_matvec_fast` has no counterpart: it
existed because gathers were slow on the TPU.
"""

from __future__ import annotations

import torch


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
