"""RIPF: radiation-induced pulmonary fibrosis model, block-sparse weak form
in torch (counterpart of rdcfes_tpu.models.ripf, itself from
src/ripf.C:337-673).

Fields HU (CT density in Hounsfield units), cc (cancer cells), fb
(fibroblasts), with

* RT-modulated rates: kappa_RT = kappa*exp(-c*RT),
  delta_RT = delta*(1 - exp(-a*RT - b*RT^2)), lambda_RT = lambda*RT/r,
  omicro_RT = omicro*max(0, 4(x - x^2)) with x = RT/r (src/ripf.C:486-489)
* HU remodeling driven by finite-difference time derivatives of cc/fb
  (src/ripf.C:467-496, 566-573)
* vacancy factor Tau = (1 - VolFr_total)^e, zero for VolFr_total >= 1 and
  below min_vacant (src/ripf.C:501-514)
* logistic-bump growth laws Koppa/Lombda/Omecro with their piecewise
  branches and derivatives (src/ripf.C:516-561)
* fibroblast transport: diffusion + haptotaxis up grad HU + radiotaxis up
  the normalized RT-dose gradient (src/ripf.C:590-592)

`fields` must contain, on the system's device: cc_dtime, fb_dtime and RT
(Q, E): the time derivatives and the total dose at the quadrature
points; RT_grad_unit (Q, 3, E): the unit gradient of the total dose.
`lambda_RT_r` and `omicro_RT_r` come from `fields` (the driver resolves
them per step, as scalars) and else from `params`.  `ripf_physics` (the
dense stacked form) belongs to the assembled path and is not here.
"""

from __future__ import annotations

import torch

from ..fem.weakform import WeakForm, WeakFormBlocks

RIPF_VARS = ("HU", "cc", "fb")


def _z(x) -> bool:
    """Structural zero: the Python scalar 0.0."""
    return isinstance(x, (int, float)) and x == 0.0


def _acc(*terms):
    """Sum of the terms that are not None, or the structural zero."""
    live = [t for t in terms if t is not None]
    if not live:
        return 0.0
    out = live[0]
    for t in live[1:]:
        out = out + t
    return out


def ripf_blocks(u_qp: torch.Tensor, grad_qp: torch.Tensor, fields,
                params) -> WeakFormBlocks:
    """Block-sparse weak form for RIPF from u_qp (3, Q, E) and grad_qp
    (3, Q, 3, E); every formula and branch is the reference's.  Only the
    fibroblast row carries transport."""
    p = params
    dt2 = p["dt"] / 2.0
    cc_dt = fields["cc_dtime"]
    fb_dt = fields["fb_dtime"]
    RT = fields["RT"]
    GRT = fields["RT_grad_unit"]
    lam_r = fields.get("lambda_RT_r", p.get("lambda_RT_r"))
    omi_r = fields.get("omicro_RT_r", p.get("omicro_RT_r"))

    HU, cc, fb = u_qp[0], u_qp[1], u_qp[2]
    GHU, Gfb = grad_qp[0], grad_qp[2]
    zero = torch.zeros_like(HU)

    kappa_RT = p["cc_kappa"] * torch.exp(-p["cc_kappa_RT_c"] * RT)
    delta_RT = p["cc_delta"] * (
        1.0 - torch.exp(-p["cc_delta_RT_a"] * RT - p["cc_delta_RT_b"] * RT**2)
    )
    lam_RT = p["fb_lambda"] * (RT / lam_r)
    x = RT / omi_r
    omi_RT = p["fb_omicro"] * torch.clamp(4.0 * (x - x**2), min=0.0)

    tol = p["phi_tolerance"]
    eps_cc = torch.where(cc_dt > tol, zero + p["phi_cc_build"],
                         torch.where(cc_dt < -tol, zero + p["phi_cc_decay"],
                                     zero))
    eps_fb = torch.where(fb_dt > tol, zero + p["phi_fb_build"],
                         torch.where(fb_dt < -tol, zero + p["phi_fb_decay"],
                                     zero))

    # vacancy factor (src/ripf.C:498-514)
    VT = p["volfr_stroma"] + p["volfr_parenchyma"] + cc + fb
    e = p["volfr_exponent"]
    base = torch.clamp(1.0 - VT, min=1e-300)
    lt1 = VT < 1.0
    tau_raw = torch.where(lt1, base**e, 0.0)
    dtau_raw = torch.where(lt1, -e * base ** (e - 1.0), 0.0)
    small = tau_raw < p["volfr_min_vacant"]
    tau = torch.where(small, 0.0, tau_raw)
    dtau = torch.where(small, 0.0, dtau_raw)  # the same for cc and fb

    # cancer-cell logistic bump (src/ripf.C:516-523)
    cc_mid = (cc >= 0.0) & (cc < 1.0)
    Koppa = torch.where(cc_mid, 4.0 * (cc - cc**2), 0.0)
    dKoppa = torch.where(cc_mid, 4.0 - 8.0 * cc, 0.0)

    # fibroblast growth laws (src/ripf.C:525-561)
    fb_mid = (fb >= 0.0) & (fb < 1.0)
    r = p["lambda_HU_r"]  # negative by contract (src/ripf.C:234-235)
    hu_ramp = (HU > r) & (HU < 0.0)
    hu_full = HU < r
    Lombda = torch.where(
        fb_mid,
        torch.where(hu_ramp, (1.0 - fb**2) * (HU / r),
                    torch.where(hu_full, 1.0 - fb**2, 0.0)),
        0.0,
    )
    L_dHU = torch.where(fb_mid & hu_ramp, (1.0 - fb**2) / r, 0.0)
    L_dfb = torch.where(
        fb_mid,
        torch.where(hu_ramp, -2.0 * fb * (HU / r),
                    torch.where(hu_full, -2.0 * fb, 0.0)),
        0.0,
    )
    b = p["omicro_fb_b"]
    Omecro = torch.where(
        fb_mid,
        torch.where(fb <= b, zero + 4.0 * (b - b**2), 4.0 * (fb - fb**2)),
        0.0,
    )
    O_dfb = torch.where(fb_mid & (fb > b), 4.0 - 8.0 * fb, 0.0)

    omega = p["fb_omega"]
    dif = p["fb_diffusion"]
    hap = p["fb_haptotaxis"]
    rad = p["fb_radiotaxis"]
    dif_live, hap_live, rad_live = not _z(dif), not _z(hap), not _z(rad)

    one = torch.ones_like(HU)
    z = 0.0

    # ---------------- RHS (src/ripf.C:566-594) ----------------------------
    A = (
        HU + dt2 * (eps_cc * cc + eps_fb * fb
                    + p["phi_cc_rate"] * cc_dt + p["phi_fb_rate"] * fb_dt),
        cc + dt2 * (kappa_RT * tau * Koppa - delta_RT * cc),
        fb + dt2 * (lam_RT * tau * Lombda + omi_RT * tau * Omecro
                    - omega * fb),
    )
    B2 = _acc(
        dt2 * (-(dif * tau)[..., None, :] * Gfb) if dif_live else None,
        dt2 * (-(hap * tau * fb)[..., None, :] * GHU) if hap_live else None,
        dt2 * (-(rad * tau * fb)[..., None, :] * GRT) if rad_live else None,
    )
    B = (z, z, B2)

    # ---------------- Jacobian (src/ripf.C:596-662) -----------------------
    C00 = one
    C01 = -dt2 * eps_cc * one
    C02 = -dt2 * eps_fb * one
    C11 = one - dt2 * (kappa_RT * dtau * Koppa + kappa_RT * tau * dKoppa
                       - delta_RT)
    C12 = -dt2 * (kappa_RT * dtau * Koppa)
    C20 = -dt2 * (lam_RT * tau * L_dHU)
    E20 = dt2 * hap * tau * fb if hap_live else z
    Dtau_fb = _acc(
        -dt2 * (-(dif * dtau)[..., None, :] * Gfb) if dif_live else None,
        -dt2 * (-(hap * dtau * fb)[..., None, :] * GHU) if hap_live else None,
        -dt2 * (-(rad * dtau * fb)[..., None, :] * GRT) if rad_live else None,
    )
    # Lombda__dcc and Omecro__dcc are zero in every reference branch
    # (src/ripf.C:536-552): only the dtau parts survive
    C21 = -dt2 * (lam_RT * dtau * Lombda + omi_RT * dtau * Omecro)
    C22 = one - dt2 * (lam_RT * dtau * Lombda + lam_RT * tau * L_dfb
                       + omi_RT * dtau * Omecro + omi_RT * tau * O_dfb
                       - omega)
    D22 = _acc(
        Dtau_fb if not _z(Dtau_fb) else None,
        -dt2 * (-(hap * tau)[..., None, :] * GHU) if hap_live else None,
        -dt2 * (-(rad * tau)[..., None, :] * GRT) if rad_live else None,
    )
    E22 = dt2 * dif * tau if dif_live else z

    C = ((C00, C01, C02), (z, C11, C12), (C20, C21, C22))
    D = ((z, z, z), (z, z, z), (z, Dtau_fb, D22))
    E = ((z, z, z), (z, z, z), (E20, z, E22))
    return WeakFormBlocks(A=A, B=B, C=C, D=D, E=E)


def ripf_physics(u_qp, grad_qp, fields, params) -> WeakForm:
    """The dense WeakForm of ripf_blocks, its structural zeros materialised:
    the `physics=` form of TransientRDCSystem's dense path
    (rdcfes_tpu/models/ripf.py:184-186)."""
    return ripf_blocks(u_qp, grad_qp, fields, params).to_dense()


def rt_dose_schedule(RT_broad, RT_focus, time, broad_fractions,
                     focus_fractions):
    """Fractionated dose accumulated by day (src/ripf.C:752-757): the broad
    beam over the first `broad_fractions` days, then the focus boost.
    RT_broad, RT_focus: tensors (any shape); time: a float or a tensor
    that broadcasts against them."""
    day = torch.floor(torch.as_tensor(time, dtype=RT_broad.dtype,
                                      device=RT_broad.device))
    total_fr = broad_fractions + focus_fractions
    return torch.where(
        day < broad_fractions,
        RT_broad / broad_fractions * (day + 1.0),
        torch.where(
            day < total_fr,
            RT_focus / focus_fractions * ((day + 1.0) - broad_fractions)
            + RT_broad,
            RT_broad + RT_focus,
        ),
    )


def default_params():
    """Defaults of the RIPF input() (src/ripf.C:171-250)."""
    return {
        "dt": 1.0e-9,
        "volfr_stroma": 0.0,
        "volfr_parenchyma": 0.0,
        "volfr_exponent": 1.0,
        "volfr_min_vacant": 1e-12,
        "phi_cc_build": 0.0,
        "phi_cc_decay": 0.0,
        "phi_cc_rate": 0.0,
        "phi_fb_build": 0.0,
        "phi_fb_decay": 0.0,
        "phi_fb_rate": 0.0,
        "phi_tolerance": 0.0,
        "cc_kappa": 0.0,
        "cc_kappa_RT_c": 0.0,
        "cc_delta": 0.0,
        "cc_delta_RT_a": 1.0,
        "cc_delta_RT_b": 1.0,
        "fb_lambda": 0.0,
        "lambda_RT_r": 1.0,
        "lambda_HU_r": -1.0,
        "fb_omicro": 0.0,
        "omicro_RT_r": 1.0,
        "omicro_fb_b": 0.0,
        "fb_omega": 0.0,
        "fb_diffusion": 0.0,
        "fb_haptotaxis": 0.0,
        "fb_radiotaxis": 0.0,
    }
