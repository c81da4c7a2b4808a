"""Krylov solvers (BiCGStab, CG, restarted GMRES) and the block-Jacobi
preconditioner in torch (counterparts of rdcfes_tpu.solvers.krylov for
the transient and solid paths).

The reference runs each iteration inside one `lax.while_loop`; here it is a
Python loop over eager tensor ops whose scalars stay on the device, with one
host read per iteration for the stopping test (GMRES reads its new
Hessenberg column instead and keeps the small least-squares problem on the
host).  Defaults mirror the implicit
libMesh/PETSc settings of the reference app: relative tolerance 1e-12 and
5000 iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..fem.assembly import NodePairSparsity, scatter_table
from ..fem.bcsr import bcsr_matvec_gather, extract_diagonal_blocks

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


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       M: Callable = _identity,
       rtol: Union[float, torch.Tensor] = DEFAULT_RTOL,
       maxiter: int = DEFAULT_MAXITER) -> SolveResult:
    """Preconditioned conjugate gradients for symmetric positive definite
    systems (e.g. pure mass solves).  Stops when |r|^2 <= (rtol |b|)^2 or
    after maxiter iterations; no breakdown guards, as the reference."""
    dt = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.sqrt(_dot(b, b))
    safe_bnorm = torch.where(bnorm == 0.0, 1.0, bnorm)
    atol2 = (torch.as_tensor(rtol, device=b.device).to(dt) * safe_bnorm) ** 2
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = _dot(r, z)
    k = 0
    go = bool(_dot(r, r) > atol2) and maxiter > 0
    while go:
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        go = bool(_dot(r, r) > atol2) and k < maxiter
    res = torch.sqrt(_dot(r, r)) / safe_bnorm
    return SolveResult(x=x, iters=k, residual=res)


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, M: Callable = _identity,
          rtol: Union[float, torch.Tensor] = DEFAULT_RTOL,
          maxiter: int = DEFAULT_MAXITER, restart: int = 30) -> SolveResult:
    """GMRES(restart) with right preconditioning, the fallback for stiff
    nonsymmetric systems.

    As the reference: classical Gram-Schmidt with one reorthogonalization
    pass (CGS2) against the whole basis, two matrix-vector products with
    the basis per pass; convergence inside a cycle is tracked through the
    Givens-updated residual estimate |g[j+1]| <= rtol |b|, and a cycle
    that meets it stops extending the basis; the true residual is
    recomputed after each cycle.  Every cycle counts `restart` iterations,
    whether it ended early or not, so `iters` is a multiple of `restart`.
    A zero Hessenberg pivot leaves that component of the update at zero.

    The basis and the vectors stay on b's device; each Arnoldi step reads
    one Hessenberg column back, and the rotations and the triangular solve
    run on the host in b's precision."""
    dt = b.dtype
    npdt = np.float32 if dt == torch.float32 else np.float64
    m = int(restart)
    n = b.numel()
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = float(torch.sqrt(_dot(b, b)))
    safe_bnorm = 1.0 if bnorm == 0.0 else bnorm
    atol = float(rtol) * safe_bnorm
    r = b - matvec(x)
    res = float(torch.sqrt(_dot(r, r)))
    total = 0
    while res > atol and total < maxiter:
        beta = res
        basis = torch.zeros((m + 1, n), dtype=dt, device=b.device)
        if beta > 0:
            basis[0] = r.reshape(-1) / beta
        H = np.zeros((m + 1, m), npdt)
        cs = np.zeros(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = beta
        for j in range(m):
            w = matvec(M(basis[j].reshape(b.shape))).reshape(-1)
            Vj = basis[:j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
            w = w - Vj.T @ h2
            hnext = torch.sqrt(_dot(w, w))
            col = torch.cat([h1 + h2, hnext[None]]).cpu().numpy()
            hn = col[j + 1]
            if hn > 0:
                basis[j + 1] = w / hnext
            # the earlier Givens rotations on the new column, then its own
            for i in range(j):
                t = cs[i] * col[i] + sn[i] * col[i + 1]
                col[i + 1] = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i] = t
            denom = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            c_new, s_new = ((1.0, 0.0) if denom == 0
                            else (col[j] / denom, col[j + 1] / denom))
            col[j] = c_new * col[j] + s_new * col[j + 1]
            col[j + 1] = 0.0
            cs[j], sn[j] = c_new, s_new
            g[j + 1] = -s_new * g[j]
            g[j] = c_new * g[j]
            H[:j + 2, j] = col
            if abs(g[j + 1]) <= atol:
                break
        # back substitution; columns the cycle never reached are zero
        y = np.zeros(m, npdt)
        for i in range(m - 1, -1, -1):
            if H[i, i] != 0:
                y[i] = (g[i] - H[i, :] @ y) / H[i, i]
        dx = M((basis[:m].T @ torch.as_tensor(y, device=b.device)
                ).reshape(b.shape))
        x = x + dx
        r = b - matvec(x)
        res = float(torch.sqrt(_dot(r, r)))
        total += m
    residual = torch.as_tensor(res / safe_bnorm, dtype=dt, device=b.device)
    return SolveResult(x=x, iters=total, residual=residual)


# ----------------------------------------------------------------------
# high-level entry: solve a block-CSR system
# ----------------------------------------------------------------------
_METHODS = {"bicgstab": bicgstab, "cg": cg, "gmres": gmres}


def solve_bcsr(values: torch.Tensor, sp: NodePairSparsity, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None, method: str = "bicgstab",
               rtol: float = DEFAULT_RTOL, maxiter: int = DEFAULT_MAXITER,
               precondition: bool = True, rows=None, cols=None,
               diag_slots=None, ops=None) -> SolveResult:
    """Solve A x = b, A the block values (V, V, nnz) over `sp`, b (V, N),
    by `method` (bicgstab, cg, gmres) with the block-Jacobi inverse of
    A's diagonal blocks as M (precondition=True) or none (the reference's
    solve_bcsr).  rows / cols / diag_slots default to sp's; the rows'
    table is made once here, and every matvec is fem.bcsr.
    bcsr_matvec_gather over it with `ops` (fem.kernels.KERNEL_OPS by
    default)."""
    dev = values.device
    row_gather = scatter_table(sp.rows if rows is None else rows,
                               sp.n_nodes, dev)
    cols = torch.as_tensor(sp.cols if cols is None else cols,
                           device=dev).long()
    matvec = lambda x: bcsr_matvec_gather(values, cols, x, row_gather,
                                          ops=ops)
    if precondition:
        diag_slots = torch.as_tensor(
            sp.diag_slots if diag_slots is None else diag_slots,
            device=dev).long()
        Dinv = block_jacobi_inverse(values, diag_slots)
        M = lambda r: apply_block_jacobi(Dinv, r)
    else:
        M = _identity
    return _METHODS[method](matvec, b, x0=x0, M=M, rtol=rtol,
                            maxiter=maxiter)
