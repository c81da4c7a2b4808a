"""Weak forms (dense and block-sparse), the element vectors and matrices of
the dense path, and the matrix-free element functions, generic (per-q
gradients, e.g. HEX8) and affine (TET4, TRI3), in torch (counterparts of
rdcfes_tpu.fem.weakform).

Per quadrature point, every RDC model contributes

  RHS   : Fe_v(i)    += JxW * ( A_v * phi_i  +  B_v . dphi_i )
  Matrix: Ke_vw(i,j) += JxW * ( C_vw * phi_j phi_i
                              + (D_vw . dphi_i) phi_j
                              + E_vw * (dphi_j . dphi_i) )

`WeakForm` stacks the five coefficient fields densely (any field may be
None); `element_vectors` and `element_matrices` build Fe (V, K, E) and
Ke (V, W, K, K, E) from it, the dense path of systems/transient.py
(plain torch, as the reference leaves them to XLA);
`block_element_matrices` builds the same Ke from a WeakFormBlocks.
`WeakFormBlocks` keeps each block as a tensor or the Python float 0.0
("structurally absent"), so a deck that turns an operator off drops its
blocks from every loop below and from the kernels' live-block lists;
`to_dense` gives its WeakForm.
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

from typing import NamedTuple, Optional

import numpy as np
import torch


def _is_zero(x) -> bool:
    return isinstance(x, (int, float)) and x == 0.0


class WeakForm(NamedTuple):
    """Per-quadrature-point weak-form coefficients, stacked densely.

      A : (V, Q, E)        rhs mass coefficient
      B : (V, Q, 3, E)     rhs flux coefficient (dotted with dphi_i)
      C : (V, V, Q, E)     jacobian mass block  (phi_j phi_i)
      D : (V, V, Q, 3, E)  jacobian taxis block ((D . dphi_i) phi_j)
      E : (V, V, Q, E)     jacobian diffusion block (dphi_j . dphi_i)

    Any field may be None, meaning identically zero."""

    A: Optional[torch.Tensor] = None
    B: Optional[torch.Tensor] = None
    C: Optional[torch.Tensor] = None
    D: Optional[torch.Tensor] = None
    E: Optional[torch.Tensor] = None


def element_vectors(wf: WeakForm, phi, JxW: torch.Tensor,
                    dphi: torch.Tensor) -> torch.Tensor:
    """Fe (V, K, E) = sum_q JxW[q] (phi[q, k] A[v, q]
    + sum_d dphi[q, k, d] B[v, q, d]) (the reference's element_vectors,
    rdcfes_tpu/fem/weakform.py:52-78, as broadcast multiply-reduces).
    phi (Q, K) host table; JxW (Q, E); dphi (Q, K, 3, E)."""
    if wf.A is None and wf.B is None:
        raise ValueError("empty weak form rhs")
    ph = _phi_tensor(phi, JxW)
    out = None
    if wf.A is not None:
        out = torch.einsum("qk,vqe->vke", ph, JxW * wf.A)
    if wf.B is not None:
        flux = torch.einsum("qkde,vqde->vke", dphi,
                            JxW[:, None, :] * wf.B)
        out = flux if out is None else out + flux
    return out


def element_matrices(wf: WeakForm, phi, JxW: torch.Tensor,
                     dphi: torch.Tensor, grad_const: bool = False,
                     return_diag: bool = False):
    """Ke (V, W, K_i, K_j, E), i the test (row) index, j the trial one:

      Ke[v, w, i, j] = sum_q JxW[q] (C[v, w, q] phi[q, i] phi[q, j]
                       + (D[v, w, q] . dphi[q, i]) phi[q, j]
                       + E[v, w, q] (dphi[q, i] . dphi[q, j]))

    (the reference's element_matrices, rdcfes_tpu/fem/weakform.py:81-180).
    grad_const=True is the affine-element route (TET4, TRI3): the shape
    gradients are dphi[0] at every q, so the diffusion term is
    (sum_q JxW E) (dphi_i . dphi_j) and the taxis term contracts D with
    phi over q before the gradients, as the reference reassociates them.
    return_diag=True also returns diag_e (V, W, K, E), the (i, i) entries
    the block-Jacobi preconditioner takes."""
    if wf.C is None and wf.D is None and wf.E is None:
        raise ValueError("empty weak form matrix")
    ph = _phi_tensor(phi, JxW)
    Ke = None

    def add(t):
        nonlocal Ke
        Ke = t if Ke is None else Ke + t

    if wf.C is not None:
        add(torch.einsum("vwqe,qij->vwije", wf.C * JxW,
                         ph[:, :, None] * ph[:, None, :]))
    Dq = None if wf.D is None else wf.D * JxW[:, None, :]
    if grad_const:
        dphi0 = dphi[0]  # (K, 3, E)
        if Dq is not None:
            Dphi = torch.einsum("vwqde,qj->vwjde", Dq, ph)
            add(torch.einsum("vwjde,ide->vwije", Dphi, dphi0))
        if wf.E is not None:
            esum = (wf.E * JxW).sum(dim=2)  # (V, W, E)
            gg = torch.einsum("ide,jde->ije", dphi0, dphi0)
            add(esum[:, :, None, None, :] * gg)
    else:
        if Dq is not None:
            t1 = torch.einsum("vwqde,qide->vwqie", Dq, dphi)
            add(torch.einsum("vwqie,qj->vwije", t1, ph))
        if wf.E is not None:
            gg = torch.einsum("qide,qjde->qije", dphi, dphi)
            add(torch.einsum("vwqe,qije->vwije", wf.E * JxW, gg))
    if return_diag:
        return Ke, torch.diagonal(Ke, dim1=2, dim2=3).movedim(-1, 2)
    return Ke


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

    def to_dense(self) -> WeakForm:
        """The WeakForm of the same values, structural zeros materialised
        (the reference's to_dense, rdcfes_tpu/fem/weakform.py:237-257)."""
        ref = next(a for a in self.A if not _is_zero(a))
        zero = torch.zeros_like(ref)
        zero3 = ref.new_zeros(ref.shape[:1] + (3,) + ref.shape[1:])
        fill = lambda x, z: z if _is_zero(x) else x.expand_as(z)
        return WeakForm(
            A=torch.stack([fill(a, zero) for a in self.A]),
            B=torch.stack([fill(b, zero3) for b in self.B]),
            C=torch.stack([torch.stack([fill(c, zero) for c in row])
                           for row in self.C]),
            D=torch.stack([torch.stack([fill(d, zero3) for d in row])
                           for row in self.D]),
            E=torch.stack([torch.stack([fill(e, zero) for e in row])
                           for row in self.E]),
        )

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


def block_element_matrices(wfb: WeakFormBlocks, phi, JxW, dphi,
                           grad_const: bool = False) -> torch.Tensor:
    """Ke (V, W, K, K, E) from the block coefficients: element_matrices'
    terms on each live (v, w) block alone, a dead block a zero block (the
    reference's block_element_matrices: the Ke of element_matrices on
    wfb.to_dense(), without contracting the dead blocks)."""
    ph = _phi_tensor(phi, JxW)
    K = ph.shape[1]
    pp = ph[:, :, None] * ph[:, None, :]  # (Q, K, K)
    zero = JxW.new_zeros((K, K, JxW.shape[-1]))
    dphi0 = dphi[0] if grad_const else None  # (K, 3, E)
    gg = None  # the gradient products, made at the first live E block
    out_rows = []
    for v in range(wfb.n_vars):
        row = []
        for w in range(wfb.n_vars):
            c, d, e = wfb.C[v][w], wfb.D[v][w], wfb.E[v][w]
            terms = []
            if not _is_zero(c):
                terms.append(torch.einsum("qe,qij->ije", c * JxW, pp))
            if not _is_zero(d):
                Dq = d * JxW[:, None, :]  # (Q, 3, E)
                if grad_const:
                    Dphi = torch.einsum("qde,qj->jde", Dq, ph)
                    terms.append(torch.einsum("jde,ide->ije", Dphi, dphi0))
                else:
                    t1 = torch.einsum("qde,qide->qie", Dq, dphi)
                    terms.append(torch.einsum("qie,qj->ije", t1, ph))
            if not _is_zero(e):
                if gg is None:
                    gg = (torch.einsum("ide,jde->ije", dphi0, dphi0)
                          if grad_const else
                          torch.einsum("qide,qjde->qije", dphi, dphi))
                if grad_const:
                    terms.append((e * JxW).sum(dim=0) * gg)
                else:
                    terms.append(torch.einsum("qe,qije->ije", e * JxW, gg))
            acc = _accum(terms)
            row.append(zero if acc is None else acc)
        out_rows.append(torch.stack(row, dim=0))
    return torch.stack(out_rows, dim=0)
