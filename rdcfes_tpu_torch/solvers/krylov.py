"""Krylov solver and block-Jacobi preconditioner in torch (transcription of
rdcfes_tpu.solvers.krylov for the transient and solid paths).

The reference runs the iteration inside one `lax.while_loop`; here it is a
Python loop over eager tensor ops whose scalars stay on the device, with one
host read per iteration for the stopping test.  Defaults mirror the implicit
libMesh/PETSc settings of the reference app: relative tolerance 1e-12 and
5000 iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from ..fem.bcsr import extract_diagonal_blocks

DEFAULT_RTOL = 1e-12
DEFAULT_MAXITER = 5000


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int               # iterations taken (maxiter after a breakdown)
    residual: torch.Tensor   # final |r| / |b|, 0-d


def small_block_inverse(D: torch.Tensor, pivot: bool = True) -> torch.Tensor:
    """Batched inverse of small channel-first blocks D (V, V, N) by
    Gauss-Jordan elimination.

    pivot=True (the reference's default): partial pivoting, the largest
    |A[r, k, n]| among rows r >= k swapped into row k; the solid tangent's
    diagonal blocks need it (penalty rows ~1e6 x the material rows).
    pivot=False skips it; the transient CN diagonal blocks are lumped mass
    plus O(dt) coupling, strongly diagonally dominant."""
    V, _, N = D.shape
    if V == 1:
        return 1.0 / D
    A = D
    Inv = torch.eye(V, dtype=D.dtype, device=D.device)[:, :, None].repeat(
        1, 1, N)
    row_ids = torch.arange(V, device=D.device)[:, None]  # (V, 1)
    for k in range(V):
        if pivot:
            col = torch.where(row_ids >= k, A[:, k, :].abs(), -torch.inf)
            p = torch.argmax(col, dim=0)  # (N,), first maximum
            perm = torch.where(row_ids == k, p[None, :],
                               torch.where(row_ids == p[None, :], k,
                                           row_ids))[:, None, :]
            A = torch.take_along_dim(A, perm, dim=0)
            Inv = torch.take_along_dim(Inv, perm, dim=0)
        pivot_val = A[k, k, :]
        Ak = A[k] / pivot_val[None, :]
        Ik = Inv[k] / pivot_val[None, :]
        factor = A[:, k, :]
        A = A - factor[:, None, :] * Ak[None, :, :]  # fresh tensors: the
        Inv = Inv - factor[:, None, :] * Ik[None, :, :]  # row writes below
        A[k] = Ak                                        # leave D intact
        Inv[k] = Ik
    return Inv


def block_jacobi_inverse(values: torch.Tensor, diag_slots: torch.Tensor,
                         pivot: bool = True) -> torch.Tensor:
    """Invert the (V, V, N) diagonal blocks of block values (V, V, nnz)."""
    return small_block_inverse(extract_diagonal_blocks(values, diag_slots),
                               pivot=pivot)


def apply_block_jacobi(Dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Dinv (V, W, N) applied to r (W, N) -> (V, N)."""
    return torch.sum(Dinv * r[None], dim=1)


def _identity(r):
    return r


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, M: Callable = _identity,
             rtol: Union[float, torch.Tensor] = DEFAULT_RTOL,
             maxiter: int = DEFAULT_MAXITER) -> SolveResult:
    """Right-preconditioned BiCGStab on arbitrarily shaped tensors.

    Stops when |r|^2 <= (rtol |b|)^2 (evaluated in b's dtype) or after
    maxiter iterations.  A breakdown (rho, r_hat.v or omega exactly zero)
    keeps the last iterate and reports maxiter iterations, as the
    reference's guards do."""
    dt = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.sqrt(_dot(b, b))
    safe_bnorm = torch.where(bnorm == 0.0, 1.0, bnorm)
    rtol_t = torch.as_tensor(rtol, device=b.device).to(dt)
    atol2 = (rtol_t * safe_bnorm) ** 2

    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=dt, device=b.device)
    rho, alpha, omega = one, one, one
    safe = lambda d: torch.where(d == 0.0, 1.0, d)
    k = 0
    go = bool(_dot(r, r) > atol2) and maxiter > 0
    while go:
        rho1 = _dot(rhat, r)
        beta = (rho1 / safe(rho)) * (alpha / safe(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        rtv = _dot(rhat, v)
        alpha_new = rho1 / safe(rtv)
        s = r - alpha_new * v
        shat = M(s)
        t = matvec(shat)
        tt = _dot(t, t)
        omega_new = torch.where(tt == 0.0, 0.0, _dot(t, s) / safe(tt))
        breakdown = (rho1 == 0.0) | (rtv == 0.0) | (omega == 0.0)
        x_new = x + alpha_new * phat + omega_new * shat
        r_new = s - omega_new * t
        flags = torch.stack([breakdown, _dot(r_new, r_new) > atol2]).tolist()
        rho, alpha, omega = rho1, alpha_new, omega_new
        if flags[0]:
            k = maxiter
            break
        x, r = x_new, r_new
        k += 1
        go = flags[1] and k < maxiter
    res = torch.sqrt(_dot(r, r)) / safe_bnorm
    return SolveResult(x=x, iters=k, residual=res)
