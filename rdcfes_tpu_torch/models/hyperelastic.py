"""Batched finite-strain hyperelastic constitutive model (torch port of
rdcfes_tpu.models.hyperelastic).

Compressible Neo-Hookean strain energy with a fibre (I4) reinforcement term
and a multiplicative growth decomposition F = Fe Fp, Fp = diag(lambda(t))
(the reference app's Hyperelastic class, src/hyperlastic_inline.h:17-189):
  dW/dI1 = mu/2,  dW/dJe = -mu/Je + (lambda/2)(Je - 1/Je),
  dW/dI4 = -koppa (koppa = FibreStiffness/2),
Cauchy stress pushed forward with the total F and J = det F, and the
spatial tangent in 6x6 Voigt ordering (00, 11, 22, 01, 12, 02).

The solid path's `stress_and_tangent_cf` keeps every 3x3 / 6x6 tensor
as a nested list of (..., E) tensors (the big axes minor), and its
arithmetic keeps the reference's operation order, so f64 results agree
to round-off.  `stress_and_tangent` (with `kinematics` and the
per-element `SolidMaterial` record) is the reference's batched form on
(..., 3, 3) tensors, the same law through einsums and the fourth-order
tangent contracted in full.  Material parameters are per-element
tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..fem.geometry import _inv3x3

# Voigt index pairs in the reference's ordering (src/hyperelastic.h:14-21)
VOIGT = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (0, 2))


class SolidMaterial(NamedTuple):
    """Per-element material constants (from the subdomain/material table)."""

    young: torch.Tensor            # (E,)
    poisson: torch.Tensor          # (E,)
    fibre_stiffness: torch.Tensor  # (E,)
    stretch_rate: torch.Tensor     # (E, 3) VolumetricStretchRatio/rate_*


def kinematics(grad_X: torch.Tensor, lam: torch.Tensor):
    """(F, Fe, Fp_inv, J) from the inverse-map gradient grad_X (..., 3, 3),
    grad_X[d, r] = dX0_d / dx_r on the current configuration
    (src/solid_system.C:221-229), and the growth stretches lam (..., 3),
    Fp = diag(lam)."""
    F, _ = _inv3x3(grad_X)  # deformation gradient = (dX/dx)^-1
    J = _det3(F)
    Fp_inv = 1.0 / lam  # diagonal
    Fe = F * Fp_inv[..., None, :]  # F @ diag(1/lam)
    return F, Fe, Fp_inv, J


def _det3(M):
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                        - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                          - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                          - M[..., 1, 1] * M[..., 2, 0]))


def stress_and_tangent(grad_X: torch.Tensor, lam: torch.Tensor,
                       eta: torch.Tensor, young: torch.Tensor,
                       poisson: torch.Tensor, fibre_k: torch.Tensor,
                       want_tangent: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """Cauchy stress (..., 3, 3), Voigt tangent (..., 6, 6) (None without
    want_tangent) and F (..., 3, 3), batched over the leading axes.

    eta (..., 3): the fibre direction in the reference configuration,
    used only where fibre_k > 0 (normalized, src/hyperelastic.h:46);
    young, poisson, fibre_k (...)."""
    mu = 0.5 * young / (1.0 + poisson)
    lame = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    koppa = fibre_k / 2.0

    F, Fe, Fp_inv, J = kinematics(grad_X, lam)

    # fibre unit vector, active only when fibre stiffness is positive
    eta_norm = torch.linalg.vector_norm(eta, dim=-1, keepdim=True)
    A = torch.where((fibre_k > 0.0)[..., None],
                    eta / torch.where(eta_norm == 0.0, 1.0, eta_norm), 0.0)

    Ce = torch.einsum("...ki,...kj->...ij", Fe, Fe)
    CeInv, _ = _inv3x3(Ce)
    Je = _det3(Fe)
    J_r = 1.0 / J

    dWdI1 = mu / 2.0
    dWdJe = -mu / Je + 0.5 * lame * Je - 0.5 * lame / Je
    dWdI4 = -koppa
    d2WdJe2 = mu / Je**2 + 0.5 * lame + 0.5 * lame / Je**2

    eye = torch.eye(3, dtype=Ce.dtype, device=Ce.device).expand(Ce.shape)
    dJedCe = 0.5 * Je[..., None, None] * CeInv
    AA = A[..., :, None] * A[..., None, :]

    S = (2.0 * dWdI1[..., None, None] * eye
         + 2.0 * dWdJe[..., None, None] * dJedCe
         + 2.0 * dWdI4[..., None, None] * AA)
    # push-forward with the total F and J (reference behavior)
    sigma = (torch.einsum("...iI,...jJ,...IJ->...ij", F, F, S)
             * J_r[..., None, None])

    if not want_tangent:
        return sigma, None, F

    # dS/dCe = 4 dWdJe d2Je/dCe2 + 4 d2WdJe2 dJedCe (x) dJedCe
    Je4 = 0.25 * Je[..., None, None, None, None]
    CiCi = CeInv[..., :, :, None, None] * CeInv[..., None, None, :, :]
    Cik_jl = CeInv[..., :, None, :, None] * CeInv[..., None, :, None, :]
    Cil_jk = CeInv[..., :, None, None, :] * CeInv[..., None, :, :, None]
    d2Je = Je4 * (CiCi - Cik_jl - Cil_jk)
    dSdCe = (4.0 * dWdJe[..., None, None, None, None] * d2Je
             + 4.0 * d2WdJe2[..., None, None, None, None]
             * dJedCe[..., :, :, None, None] * dJedCe[..., None, None, :, :])
    # the growth pullback: dCe/dC through the diagonal Fp_inv, a scaling
    # of the last two indices and a symmetrization
    w = Fp_inv  # (..., 3)
    scaled = dSdCe * w[..., None, None, :, None] * w[..., None, None, None, :]
    dSdC = 0.5 * (scaled + scaled.transpose(-1, -2))
    # spatial tangent: (1/J) F F F F : dSdC
    FS = torch.einsum("...iI,...jJ,...IJkl->...ijkl", F, F, dSdC)
    tsm = (torch.einsum("...kK,...lL,...ijKL->...ijkl", F, F, FS)
           * J_r[..., None, None, None, None])
    # condense to 6x6 Voigt
    tangent = torch.stack([
        torch.stack([tsm[..., i, j, k, l] for (k, l) in VOIGT], dim=-1)
        for (i, j) in VOIGT], dim=-2)
    return sigma, tangent, F


# Tangent derivation (as the reference): with Ci = Ce^-1,
#   dS/dCe = alpha Ci (x) Ci + beta (Ci[I,K] Ci[J,L] + Ci[I,L] Ci[J,K])
#   alpha  = dWdJe Je + d2WdJe2 Je^2,   beta = -dWdJe Je
# (the I4 term has constant dW/dI4, so no tangent).  The growth pullback
# scales by w = Fp^-1 and the push-forward contracts with the total F:
#   tsm = (1/J) [ alpha P (x) Qm + beta (Hm[i,k] Hm[j,l] + Hm[i,l] Hm[j,k]) ]
#   P = F Ci F^T,  Qm = F Ciw F^T (Ciw = w_K w_L Ci),  Hm = F CiW F^T
#   (CiW = Ci with columns scaled by w).


def _m3(fn):
    return [[fn(i, j) for j in range(3)] for i in range(3)]


def _mm(A, B):
    """C = A @ B on 3x3 lists of batched tensors."""
    return _m3(lambda i, j: A[i][0] * B[0][j] + A[i][1] * B[1][j]
               + A[i][2] * B[2][j])


def _mmT(A, B):
    """C = A @ B^T."""
    return _m3(lambda i, j: A[i][0] * B[j][0] + A[i][1] * B[j][1]
               + A[i][2] * B[j][2])


def _det3_cf(M):
    return (M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1])
            - M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0])
            + M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]))


def _inv3_cf(M):
    A = M[1][1] * M[2][2] - M[1][2] * M[2][1]
    B = -(M[1][0] * M[2][2] - M[1][2] * M[2][0])
    C = M[1][0] * M[2][1] - M[1][1] * M[2][0]
    det = M[0][0] * A + M[0][1] * B + M[0][2] * C
    r = 1.0 / det
    inv = [
        [A * r, -(M[0][1] * M[2][2] - M[0][2] * M[2][1]) * r,
         (M[0][1] * M[1][2] - M[0][2] * M[1][1]) * r],
        [B * r, (M[0][0] * M[2][2] - M[0][2] * M[2][0]) * r,
         -(M[0][0] * M[1][2] - M[0][2] * M[1][0]) * r],
        [C * r, -(M[0][0] * M[2][1] - M[0][1] * M[2][0]) * r,
         (M[0][0] * M[1][1] - M[0][1] * M[1][0]) * r],
    ]
    return inv, det


def stress_and_tangent_cf(grad_X, lam, eta, young, poisson, fibre_k,
                          want_tangent: bool = True):
    """Channel-first constitutive evaluation.

    grad_X : 3x3 nested list of (..., E) tensors, grad_X[d][r] = dX0_d/dx_r
    lam    : [3] of (..., E) growth stretches
    eta    : [3] of (..., E) fibre direction (reference configuration)
    young, poisson, fibre_k : (..., E)

    Returns (sigma 3x3 list, tangent 6x6 list or None, F 3x3 list)."""
    mu = 0.5 * young / (1.0 + poisson)
    lame = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    koppa = fibre_k / 2.0

    F, det_gradX = _inv3_cf(grad_X)  # F = (dX/dx)^-1
    J = 1.0 / det_gradX              # det F = 1 / det(grad_X)
    w = [1.0 / lam[d] for d in range(3)]
    Fe = _m3(lambda i, j: F[i][j] * w[j])
    Ce = _m3(lambda i, j: Fe[0][i] * Fe[0][j] + Fe[1][i] * Fe[1][j]
             + Fe[2][i] * Fe[2][j])
    Ci, _detCe = _inv3_cf(Ce)
    Je = _det3_cf(Fe)
    J_r = 1.0 / J

    # fibre unit vector where fibre stiffness is active
    en = torch.sqrt(eta[0] ** 2 + eta[1] ** 2 + eta[2] ** 2)
    en_safe = torch.where(en == 0.0, 1.0, en)
    active = fibre_k > 0.0
    A = [torch.where(active, eta[d] / en_safe, 0.0) for d in range(3)]
    FA = [F[i][0] * A[0] + F[i][1] * A[1] + F[i][2] * A[2] for i in range(3)]

    dWdI1 = mu / 2.0
    dWdJe = -mu / Je + 0.5 * lame * Je - 0.5 * lame / Je
    dWdI4 = -koppa
    d2WdJe2 = mu / Je**2 + 0.5 * lame + 0.5 * lame / Je**2

    # sigma = (1/J)[ 2 dWdI1 F F^T + dWdJe Je P + 2 dWdI4 (FA)(FA)^T ]
    P = _mmT(_mm(F, Ci), F)  # F Ci F^T
    FFt = _mmT(F, F)
    s_vol = dWdJe * Je
    sigma = _m3(lambda i, j: J_r * (2.0 * dWdI1 * FFt[i][j]
                                    + s_vol * P[i][j]
                                    + 2.0 * dWdI4 * FA[i] * FA[j]))
    if not want_tangent:
        return sigma, None, F

    alpha = dWdJe * Je + d2WdJe2 * Je * Je
    beta = -dWdJe * Je
    Ciw = _m3(lambda k, l: Ci[k][l] * w[k] * w[l])
    CiW = _m3(lambda k, l: Ci[k][l] * w[l])
    Qm = _mmT(_mm(F, Ciw), F)
    Hm = _mmT(_mm(F, CiW), F)

    def tsm(i, j, k, l):
        return J_r * (alpha * P[i][j] * Qm[k][l]
                      + beta * (Hm[i][k] * Hm[j][l] + Hm[i][l] * Hm[j][k]))

    tangent = [[tsm(i, j, k, l) for (k, l) in VOIGT] for (i, j) in VOIGT]
    return sigma, tangent, F
