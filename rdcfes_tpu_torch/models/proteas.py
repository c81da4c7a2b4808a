"""PROTEAS: 5-species radiotherapy tumour-response model, block-sparse weak
form in torch (counterpart of rdcfes_tpu.models.proteas, itself from
src/proteas.C:338-705).

Species hos (host), tum (tumour), nec (necrotic), vsc (vascular), oed
(oedema), with

* crowding Kappa = clip(1 - T/T_max, 0, 1) whose derivative is the
  UNCONDITIONAL -1/T_max, even where Kappa is clamped
  (src/proteas.C:489-491)
* heaviside vascular-threshold gates on proliferation
  (src/proteas.C:493-514)
* radiotherapy death delta*(1 - exp(-a*RTD - b*RTD^2))
  (src/proteas.C:495, 500)
* tanh necrosis clearance psi_n*(1 - tanh(k_n*vsc - u_n)) with its exact
  derivative (src/proteas.C:504-505)
* oedema RT source xi_e*(RTD/RT_max)^p (src/proteas.C:513)

Two quirks of the C++ reference are kept, as the reference package keeps
them: Ke[1][1] has no D_c_h cross-diffusion terms (src/proteas.C:605-615),
and Ke[3][1] keeps only the dKappa part (src/proteas.C:661-665).

`fields` must contain "RTD": the dose at the quadrature points, (Q, E) on
the system's device (the driver interpolates it from the nodal AUX file).
A diffusivity that the deck sets to the literal 0.0 drops its blocks, so
they never reach a kernel.  `proteas_physics` (the dense stacked form)
belongs to the assembled path and is not here.
"""

from __future__ import annotations

import torch

from ..fem.weakform import WeakForm, WeakFormBlocks
from .response import heaviside

PROTEAS_VARS = ("hos", "tum", "nec", "vsc", "oed")


def _z(x) -> bool:
    """Structural zero: the Python scalar 0.0."""
    return isinstance(x, (int, float)) and x == 0.0


def _sum(terms):
    """Sum of the live terms, or the structural zero."""
    if not terms:
        return 0.0
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def proteas_blocks(u_qp: torch.Tensor, grad_qp: torch.Tensor, fields,
                   params) -> WeakFormBlocks:
    """Block-sparse weak form for PROTEAS from u_qp (5, Q, E) and grad_qp
    (5, Q, 3, E); every formula is the reference's."""
    p = params
    dt2 = p["dt"] / 2.0
    RTD = fields["RTD"]  # (Q, E)

    T_max = p["cells_total_capacity"]
    RT_max = p["radiotherapy_max_dosage"]
    rho_h, u_h = p["host_proliferation"], p["host_vsc_threshold"]
    delta_h, a_h, b_h = (p["host_RT_death_rate"], p["host_RT_exp_a"],
                         p["host_RT_exp_b"])
    nu_h = p["host_necrosis_rate"]
    D_c, D_c_h = p["tumour_diffusion"], p["tumour_diffusion_host"]
    rho_c, u_c = p["tumour_proliferation"], p["tumour_vsc_threshold"]
    delta_c, a_c, b_c = (p["tumour_RT_death_rate"], p["tumour_RT_exp_a"],
                         p["tumour_RT_exp_b"])
    nu_c = p["tumour_necrosis_rate"]
    psi_n, k_n, u_n = (p["necrosis_clearance"], p["necrosis_slope"],
                       p["necrosis_vsc_threshold"])
    rho_v, nu_v = p["vascular_proliferation"], p["vascular_necrosis_rate"]
    D_e, rho_e, u_e = (p["oedema_diffusion"], p["oedema_proliferation"],
                       p["oedema_vsc_threshold"])
    xi_e, p_RT_e, psi_e = (p["oedema_RT_coeff"], p["oedema_RT_exp"],
                           p["oedema_reabsorption_rate"])

    hos, tum, nec, vsc, oed = u_qp[0], u_qp[1], u_qp[2], u_qp[3], u_qp[4]
    Ghos, Gtum, Goed = grad_qp[0], grad_qp[1], grad_qp[4]

    T = hos + tum + nec + vsc
    Kappa = torch.clamp(1.0 - T / T_max, 0.0, 1.0)
    dKappa = -1.0 / T_max  # unconditional, even where clamped

    host_prol = rho_h * Kappa * heaviside(vsc - u_h)
    dhost_prol = rho_h * dKappa * heaviside(vsc - u_h)
    host_RT_death = delta_h * (1.0 - torch.exp(-a_h * RTD - b_h * RTD**2))
    host_nec = nu_h * nec

    tum_prol = rho_c * Kappa * heaviside(vsc - u_c)
    dtum_prol = rho_c * dKappa * heaviside(vsc - u_c)
    tum_RT_death = delta_c * (1.0 - torch.exp(-a_c * RTD - b_c * RTD**2))
    tum_nec = nu_c * nec

    nec_prol = nu_h * hos + nu_c * tum + nu_v * vsc
    nec_clear = psi_n * (1.0 - torch.tanh(k_n * vsc - u_n))
    dnec_clear_dv = psi_n * -k_n / torch.cosh(k_n * vsc - u_n) ** 2

    vsc_prol = rho_v * Kappa * tum
    dvsc_prol = rho_v * dKappa * tum
    vsc_nec = nu_v * nec

    oed_prol = rho_e * tum * (1.0 - tum)
    doed_prol_dc = rho_e * (1.0 - 2.0 * tum)
    oed_RT = xi_e * (RTD / RT_max) ** p_RT_e
    oed_clear = psi_e * (1.0 - heaviside(vsc - u_e))

    one = torch.ones_like(hos)
    z = 0.0
    dc_live, dch_live, de_live = (not _z(D_c), not _z(D_c_h),
                                  not _z(D_e))

    # ---------------- RHS -------------------------------------------------
    A = (
        hos + dt2 * (host_prol * hos * (1.0 - hos) - host_RT_death * hos
                     - host_nec * hos),
        tum + dt2 * (tum_prol * tum - tum_RT_death * tum - tum_nec * tum),
        nec + dt2 * (nec_prol * nec - nec_clear * nec),
        vsc + dt2 * (vsc_prol * vsc - vsc_nec * vsc),
        oed + dt2 * (oed_prol * oed - oed_RT * oed - oed_clear * oed),
    )
    B1 = []
    if dc_live:
        B1.append(-(D_c * Kappa)[..., None, :] * Gtum)
    if dch_live:
        B1.append(-(D_c_h * Kappa * tum)[..., None, :] * Ghos)
    B = (z, dt2 * _sum(B1) if B1 else z, z, z,
         dt2 * (-D_e) * Goed if de_live else z)

    # ---------------- Jacobian (src/proteas.C:566-697) --------------------
    hh = dhost_prol * hos * (1.0 - hos)
    C00 = one - dt2 * (hh + host_prol * (1.0 - 2.0 * hos)
                       - host_RT_death - host_nec)
    C01 = -dt2 * hh
    C02 = -dt2 * (hh - nu_h * hos)
    C03 = -dt2 * hh

    Dk = []
    if dc_live:
        Dk.append((-D_c * dKappa) * Gtum)
    if dch_live:
        Dk.append((-D_c_h * dKappa) * tum[..., None, :] * Ghos)
    Dkap_tum = -dt2 * _sum(Dk) if Dk else z
    C10 = -dt2 * (dtum_prol * tum)
    D10 = Dkap_tum
    E10 = dt2 * D_c_h * Kappa * tum if dch_live else z
    C11 = one - dt2 * (dtum_prol * tum + tum_prol - tum_RT_death - tum_nec)
    D11 = -dt2 * (-D_c * dKappa) * Gtum if dc_live else z
    E11 = dt2 * D_c * Kappa if dc_live else z
    C12 = -dt2 * (dtum_prol * tum - nu_c * tum)
    C13 = -dt2 * (dtum_prol * tum)

    C20 = -dt2 * (nu_h * nec)
    C21 = -dt2 * (nu_c * nec)
    C22 = one - dt2 * (nec_prol - nec_clear)
    C23 = -dt2 * (nu_v * nec - dnec_clear_dv * nec)

    C30 = -dt2 * (dvsc_prol * vsc)
    C31 = -dt2 * (dvsc_prol * vsc)
    C32 = -dt2 * (dvsc_prol * vsc - nu_v * vsc)
    C33 = one - dt2 * (dvsc_prol * vsc + vsc_prol - vsc_nec)

    C41 = -dt2 * (doed_prol_dc * oed)
    C44 = one - dt2 * (oed_prol - oed_RT - oed_clear)
    E44 = dt2 * D_e * one if de_live else z

    C = (
        (C00, C01, C02, C03, z),
        (C10, C11, C12, C13, z),
        (C20, C21, C22, C23, z),
        (C30, C31, C32, C33, z),
        (z, C41, z, z, C44),
    )
    zr = (z, z, z, z, z)
    D = (zr, (D10, D11, Dkap_tum, Dkap_tum, z), zr, zr, zr)
    E = (zr, (E10, E11, z, z, z), zr, zr, (z, z, z, z, E44))
    return WeakFormBlocks(A=A, B=B, C=C, D=D, E=E)


def proteas_physics(u_qp, grad_qp, fields, params) -> WeakForm:
    """The dense WeakForm of proteas_blocks, its structural zeros materialised:
    the `physics=` form of TransientRDCSystem's dense path
    (rdcfes_tpu/models/proteas.py:196-198)."""
    return proteas_blocks(u_qp, grad_qp, fields, params).to_dense()


def default_params():
    """Defaults of the PROTEAS input() (src/proteas.C:178-213): every model
    parameter defaults to 1.0."""
    keys = [
        "cells_total_capacity", "radiotherapy_max_dosage",
        "host_proliferation", "host_vsc_threshold", "host_RT_death_rate",
        "host_RT_exp_a", "host_RT_exp_b", "host_necrosis_rate",
        "tumour_diffusion", "tumour_diffusion_host", "tumour_proliferation",
        "tumour_vsc_threshold", "tumour_RT_death_rate", "tumour_RT_exp_a",
        "tumour_RT_exp_b", "tumour_necrosis_rate",
        "necrosis_clearance", "necrosis_slope", "necrosis_vsc_threshold",
        "vascular_proliferation", "vascular_necrosis_rate",
        "oedema_diffusion", "oedema_proliferation", "oedema_vsc_threshold",
        "oedema_oedema_threshold", "oedema_RT_coeff", "oedema_RT_exp",
        "oedema_reabsorption_rate",
    ]
    d = {k: 1.0 for k in keys}
    d["dt"] = 1.0e-9
    return d
