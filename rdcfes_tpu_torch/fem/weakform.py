"""Block-sparse weak form and the matrix-free element functions, generic
(per-q gradients, e.g. HEX8) and affine (TET4), in torch (counterparts of
rdcfes_tpu.fem.weakform).

Per quadrature point, every RDC model contributes

  RHS   : Fe_v(i)    += JxW * ( A_v * phi_i  +  B_v . dphi_i )
  Matrix: Ke_vw(i,j) += JxW * ( C_vw * phi_j phi_i
                              + (D_vw . dphi_i) phi_j
                              + E_vw * (dphi_j . dphi_i) )

`WeakFormBlocks` keeps each block as a tensor or the Python float 0.0
("structurally absent"), so a deck that turns an operator off drops its
blocks from every loop below and from the kernels' live-block lists.
The Krylov matvec applies the blocks straight from the coefficients:
(A x)_i = sum_q JxW [phi_qi C.x_qp + dphi_qi . (D x_qp + E gx_qp)].

Layout: element axis last.  phi is the host (Q, K) table; JxW (Q, E);
dphi (Q, K, 3, E).

The generic functions (block_rhs, qp_apply, block_diag) are broadcast
multiply-reduces over the q, k and d axes, a few whole-plane ops per live
block; the reference unrolls the same sums term by term, so the two agree
to f64 reassociation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _is_zero(x) -> bool:
    return isinstance(x, (int, float)) and x == 0.0


class WeakFormBlocks(NamedTuple):
    """Per-block coefficients; any entry may be the Python float 0.0.

    A : [V] of (Q, E)        rhs mass coefficients
    B : [V] of (Q, 3, E)     rhs flux coefficients
    C : [V][V] of (Q, E)     jacobian mass blocks
    D : [V][V] of (Q, 3, E)  jacobian taxis blocks
    E : [V][V] of (Q, E)     jacobian diffusion blocks
    """

    A: tuple
    B: tuple
    C: tuple
    D: tuple
    E: tuple

    @property
    def n_vars(self) -> int:
        return len(self.A)

    def cast(self, dtype: torch.dtype) -> "WeakFormBlocks":
        f = lambda x: x if _is_zero(x) else x.to(dtype)
        return WeakFormBlocks(
            A=tuple(f(a) for a in self.A),
            B=tuple(f(b) for b in self.B),
            C=tuple(tuple(f(c) for c in row) for row in self.C),
            D=tuple(tuple(f(d) for d in row) for row in self.D),
            E=tuple(tuple(f(e) for e in row) for row in self.E),
        )


def _accum(terms):
    live = [t for t in terms if t is not None]
    if not live:
        return None
    acc = live[0]
    for t in live[1:]:
        acc = acc + t
    return acc


def _zeros_e(JxW: torch.Tensor) -> torch.Tensor:
    return torch.zeros(JxW.shape[-1], dtype=JxW.dtype, device=JxW.device)


def _phi_tensor(phi, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(phi), dtype=like.dtype,
                           device=like.device)


def _project(ph, JxW, dphi, a, b):
    """(K, E) = sum_q JxW[q] (phi[q, k] a[q] + sum_d dphi[q, k, d] b[q, d])
    for a (Q, E) or None and b (Q, 3, E) or None (not both None)."""
    out = None
    if a is not None:
        out = (ph[:, :, None] * (JxW * a)[:, None, :]).sum(dim=0)
    if b is not None:
        flux = (dphi * (JxW[:, None, :] * b)[:, None]).sum(dim=(0, 2))
        out = flux if out is None else out + flux
    return out


def _stack_rows(rows, K: int, JxW: torch.Tensor) -> torch.Tensor:
    """Stack per-species (K, E) rows; None = a species with no live block."""
    zero = torch.zeros((K, JxW.shape[-1]), dtype=JxW.dtype, device=JxW.device)
    return torch.stack([zero if r is None else r for r in rows], dim=0)


def block_rhs(wfb: WeakFormBlocks, phi, JxW, dphi) -> torch.Tensor:
    """Fe (V, K, E) from the A/B blocks with per-q gradients dphi
    (Q, K, 3, E); a species without live blocks contributes zeros."""
    ph = _phi_tensor(phi, JxW)
    rows = []
    for v in range(wfb.n_vars):
        a = None if _is_zero(wfb.A[v]) else wfb.A[v]
        b = None if _is_zero(wfb.B[v]) else wfb.B[v]
        rows.append(None if a is None and b is None
                    else _project(ph, JxW, dphi, a, b))
    return _stack_rows(rows, ph.shape[1], JxW)


def qp_apply(wfb: WeakFormBlocks, phi, JxW, dphi, x_qp, gx_qp
             ) -> torch.Tensor:
    """Element contributions Ye (V, K, E) of the LHS operator applied to a
    vector interpolated at quadrature points, the matrix-free matvec core
    for per-q gradients.  x_qp (V, Q, E); gx_qp (V, Q, 3, E)
    (fem.assembly.interpolate_ue)."""
    V = wfb.n_vars
    ph = _phi_tensor(phi, JxW)
    rows = []
    for v in range(V):
        # mass response a (Q, E), flux response b (Q, 3, E)
        a = _accum([wfb.C[v][w] * x_qp[w] for w in range(V)
                    if not _is_zero(wfb.C[v][w])])
        b = _accum([wfb.D[v][w] * x_qp[w][:, None, :] for w in range(V)
                    if not _is_zero(wfb.D[v][w])]
                   + [wfb.E[v][w][:, None, :] * gx_qp[w] for w in range(V)
                      if not _is_zero(wfb.E[v][w])])
        rows.append(None if a is None and b is None
                    else _project(ph, JxW, dphi, a, b))
    return _stack_rows(rows, ph.shape[1], JxW)


def block_diag(wfb: WeakFormBlocks, phi, JxW, dphi) -> torch.Tensor:
    """diag_e (V, V, K, E): the per-element (i, i) entries of each (v, w)
    block for the block-Jacobi preconditioner, straight from the
    coefficients, with per-q gradients."""
    V = wfb.n_vars
    ph = _phi_tensor(phi, JxW)
    K = ph.shape[1]
    ph2 = ph * ph
    gg = (dphi * dphi).sum(dim=2)  # (Q, K, E)
    out_rows = []
    for v in range(V):
        row = []
        for w in range(V):
            terms = []
            if not _is_zero(wfb.C[v][w]):
                terms.append((ph2[:, :, None]
                              * (JxW * wfb.C[v][w])[:, None, :]).sum(dim=0))
            if not _is_zero(wfb.D[v][w]):
                dd = (dphi * (JxW[:, None, :] * wfb.D[v][w])[:, None]
                      ).sum(dim=2)  # (Q, K, E)
                terms.append((ph[:, :, None] * dd).sum(dim=0))
            if not _is_zero(wfb.E[v][w]):
                terms.append((gg * (JxW * wfb.E[v][w])[:, None, :]
                              ).sum(dim=0))
            row.append(_accum(terms))
        out_rows.append(_stack_rows(row, K, JxW))
    return torch.stack(out_rows, dim=0)


def block_rhs_affine(wfb: WeakFormBlocks, phi, JxW, dphi) -> torch.Tensor:
    """Fe (V, K, E) from the A/B blocks of an AFFINE element: the flux
    term's q-sum sum_q JxW[q] B[v][q, d] is taken once per direction."""
    Q, K = phi.shape
    dphi0 = dphi[0]
    rows = []
    for v in range(wfb.n_vars):
        Bsum = None
        if not _is_zero(wfb.B[v]):
            Bsum = []
            for d in range(3):
                acc = JxW[0] * wfb.B[v][0, d]
                for q in range(1, Q):
                    acc = acc + JxW[q] * wfb.B[v][q, d]
                Bsum.append(acc)
        cols = []
        for k in range(K):
            terms = []
            if not _is_zero(wfb.A[v]):
                for q in range(Q):
                    terms.append((JxW[q] * float(phi[q, k])) * wfb.A[v][q])
            if Bsum is not None:
                for d in range(3):
                    terms.append(dphi0[k, d] * Bsum[d])
            acc = _accum(terms)
            cols.append(_zeros_e(JxW) if acc is None else acc)
        rows.append(torch.stack(cols, dim=0))
    return torch.stack(rows, dim=0)


def diffusion_presum(wfb: WeakFormBlocks, JxW):
    """Per-step q-sum of the diffusion blocks for the affine apply:
    Epre[v][w] = sum_q JxW[q] E[v][w][q] (E,), or 0.0 where E is absent.
    Computed in JxW's dtype, so an f32 form gives the f32 sums."""
    V = wfb.n_vars
    Q = JxW.shape[0]
    rows = []
    for v in range(V):
        row = []
        for w in range(V):
            if _is_zero(wfb.E[v][w]):
                row.append(0.0)
                continue
            acc = JxW[0] * wfb.E[v][w][0]
            for q in range(1, Q):
                acc = acc + JxW[q] * wfb.E[v][w][q]
            row.append(acc)
        rows.append(tuple(row))
    return tuple(rows)


def qp_apply_affine(wfb: WeakFormBlocks, Epre, phi, JxW, dphi,
                    x_qp, gx) -> torch.Tensor:
    """Element contributions Ye (V, K, E) of the LHS operator applied to a
    vector interpolated at quadrature points, for AFFINE elements: the flux
    response contracts over q before the k-projection and the diffusion
    q-sum comes pre-summed in Epre (diffusion_presum).

    x_qp (V, Q, E); gx (V, 3, E) (interpolate_ue_affine)."""
    V = wfb.n_vars
    Q, K = phi.shape
    A_coef = []
    for v in range(V):
        zq = []
        for q in range(Q):
            terms = [wfb.C[v][w][q] * x_qp[w, q]
                     for w in range(V) if not _is_zero(wfb.C[v][w])]
            zq.append(_accum(terms))
        A_coef.append(zq)
    Fd = []
    for v in range(V):
        per_d = []
        for d in range(3):
            terms = []
            for w in range(V):
                if not _is_zero(wfb.D[v][w]):
                    acc = (JxW[0] * wfb.D[v][w][0, d]) * x_qp[w, 0]
                    for q in range(1, Q):
                        acc = acc + (JxW[q] * wfb.D[v][w][q, d]) * x_qp[w, q]
                    terms.append(acc)
                if not _is_zero(Epre[v][w]):
                    terms.append(Epre[v][w] * gx[w, d])
            per_d.append(_accum(terms))
        Fd.append(per_d)
    dphi0 = dphi[0]
    rows = []
    for v in range(V):
        cols = []
        for k in range(K):
            terms = []
            for q in range(Q):
                if A_coef[v][q] is not None:
                    terms.append((JxW[q] * float(phi[q, k])) * A_coef[v][q])
            for d in range(3):
                if Fd[v][d] is not None:
                    terms.append(dphi0[k, d] * Fd[v][d])
            acc = _accum(terms)
            cols.append(_zeros_e(JxW) if acc is None else acc)
        rows.append(torch.stack(cols, dim=0))
    return torch.stack(rows, dim=0)


def block_diag_affine(wfb: WeakFormBlocks, phi, JxW, dphi) -> torch.Tensor:
    """diag_e (V, V, K, E): the per-element (i, i) entries of each (v, w)
    block for the block-Jacobi preconditioner, straight from the
    coefficients of an AFFINE element."""
    V = wfb.n_vars
    Q, K = phi.shape
    zero = _zeros_e(JxW)
    dphi0 = dphi[0]
    Epre = diffusion_presum(wfb, JxW)
    gg = [dphi0[i, 0] * dphi0[i, 0] + dphi0[i, 1] * dphi0[i, 1]
          + dphi0[i, 2] * dphi0[i, 2] for i in range(K)]
    out_rows = []
    for v in range(V):
        row = []
        for w in range(V):
            cols = []
            for i in range(K):
                terms = []
                if not _is_zero(wfb.C[v][w]):
                    acc = ((JxW[0] * float(phi[0, i] * phi[0, i]))
                           * wfb.C[v][w][0])
                    for q in range(1, Q):
                        acc = acc + ((JxW[q] * float(phi[q, i] * phi[q, i]))
                                     * wfb.C[v][w][q])
                    terms.append(acc)
                if not _is_zero(wfb.D[v][w]):
                    for d in range(3):
                        acc = (JxW[0] * float(phi[0, i])) * wfb.D[v][w][0, d]
                        for q in range(1, Q):
                            acc = acc + ((JxW[q] * float(phi[q, i]))
                                         * wfb.D[v][w][q, d])
                        terms.append(dphi0[i, d] * acc)
                if not _is_zero(Epre[v][w]):
                    terms.append(Epre[v][w] * gg[i])
                acc = _accum(terms)
                cols.append(zero if acc is None else acc)
            row.append(torch.stack(cols, dim=0))
        out_rows.append(torch.stack(row, dim=0))
    return torch.stack(out_rows, dim=0)
