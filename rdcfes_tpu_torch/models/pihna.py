"""PIHNA: 5-species glioma growth model, block-sparse weak form in torch
(transcription of rdcfes_tpu.models.pihna, itself from src/pihna.C:318-758).

Species n (necrotic), c (normoxic tumor), h (hypoxic tumor),
v (vasculature), a (angiogenic factor), with

* crowding factor Tau = (1 - (n+c+h+v)/Kappa_k)^ek, clamped with zero
  derivative outside (0, 1) (src/pihna.C:444-472)
* vascular fraction Ve = v/(c+h+v), clamped to [0, 1] (src/pihna.C:474-499;
  Ve = 0 where c+h+v == 0, the reference package's documented deviation)
* angiogenic saturation Ua = a/(a+Kappa_a) (src/pihna.C:501-502)
* per-species threshold gating of diffusion/taxis at Lambda_k
  (src/pihna.C:504-509)
* the full 25-block analytic Jacobian, including the reference's
  incomplete Ke[3][3] (src/pihna.C:708-718), reproduced for parity.

Deck parameters arrive as plain Python floats; a block whose scalar
prefactors are all 0.0 stays the Python float 0.0 and drops out of every
kernel's live-block lists.
"""

from __future__ import annotations

import torch

from ..fem.weakform import WeakForm, WeakFormBlocks

PIHNA_VARS = ("n", "c", "h", "v", "a")


def crowding_factor(total_over_kappa: torch.Tensor, kappa_k: float,
                    ek: float):
    """(Tau, dTau/d rho_i) with the reference's clamped branches; the
    derivative is the same for every species.  tau = base**(ek-1) * base,
    with an integer multiply chain when ek - 1 is a small integer."""
    Te = total_over_kappa
    base = torch.clamp(1.0 - Te, 1e-300, 1.0)
    interior = (Te > 0.0) & (Te < 1.0)
    e1 = ek - 1.0
    if isinstance(e1, float) and e1.is_integer() and 0.0 <= e1 <= 8.0:
        pe1 = _int_pow(base, int(e1))
    else:
        pe1 = base ** e1
    tau = torch.where(Te <= 0.0, 1.0,
                      torch.where(interior, pe1 * base, 0.0))
    dtau = torch.where(interior, (-ek / kappa_k) * pe1, 0.0)
    return tau, dtau


def _int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by square-and-multiply (the multiply chain XLA's integer_pow
    emits for the reference's `base ** int(e1)`)."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    p = x
    while n:
        if n & 1:
            acc = p if acc is None else acc * p
        n >>= 1
        if n:
            p = p * p
    return acc


def vascular_fraction(c, h, v):
    """(Ve, dVe/dc = dVe/dh, dVe/dv) with clamped branches."""
    s = c + h + v
    safe_s = torch.where(s == 0.0, 1.0, s)
    Ve_ = v / safe_s
    interior = (Ve_ > 0.0) & (Ve_ < 1.0)
    Ve = torch.clamp(Ve_, 0.0, 1.0)
    dVe_dch = torch.where(interior, -Ve_ / safe_s, 0.0)
    dVe_dv = torch.where(interior, (1.0 - Ve_) / safe_s, 0.0)
    return Ve, dVe_dch, dVe_dv


def _z(x) -> bool:
    """Structural zero: the Python scalar 0.0."""
    return isinstance(x, (int, float)) and x == 0.0


def _mul(*fs):
    """Zero-propagating product of scalars/tensors."""
    for f in fs:
        if _z(f):
            return 0.0
    acc = fs[0]
    for f in fs[1:]:
        acc = acc * f
    return acc


def _add(*terms):
    """Sum skipping structural zeros."""
    live = [t for t in terms if not _z(t)]
    if not live:
        return 0.0
    acc = live[0]
    for t in live[1:]:
        acc = acc + t
    return acc


def _neg(x):
    return 0.0 if _z(x) else -x


def _gate(value, cond: torch.Tensor, dtype: torch.dtype):
    """Threshold gating that stays a structural zero when the deck turns
    the coefficient off; otherwise `value` where cond holds, in dtype."""
    if _z(value):
        return 0.0
    live = torch.full(cond.shape, value, dtype=dtype, device=cond.device)
    return torch.where(cond, live, 0.0)


def _bvec(coef, G):
    """(Q, E) coefficient x (Q, 3, E) gradient -> (Q, 3, E) flux term."""
    if _z(coef):
        return 0.0
    return coef[..., None, :] * G


def pihna_blocks(u_qp: torch.Tensor, grad_qp: torch.Tensor, fields, params
                 ) -> WeakFormBlocks:
    """Block-sparse weak form for PIHNA from u_qp (5, Q, E) and grad_qp
    (5, Q, 3, E); every formula is the reference's (src/pihna.C:444-747).
    `fields` is unused (PIHNA has no auxiliary fields)."""
    p = params
    dt2 = p["dt"] / 2.0
    Lk = p["cells_min_capacity"]
    Kk = p["cells_max_capacity"]
    Ka = p["cytokines_max_capacity"]
    ek = p["cells_max_capacity_exponent"]
    nec_c, nec_h, nec_v = p["necrosis_c"], p["necrosis_h"], p["necrosis_v"]
    prod_c, sw_c2h, sw_h2c, sw_h2n = (
        p["produce_c"], p["switch_c2h"], p["switch_h2c"], p["switch_h2n"],
    )
    prod_v = p["produce_v"]
    sec_ac, sec_ah, upt_av, dec_a = (
        p["secrete_a_c"], p["secrete_a_h"], p["uptake_a_v"], p["decay_a"],
    )
    dtype = u_qp.dtype

    n, c, h, v, a = u_qp[0], u_qp[1], u_qp[2], u_qp[3], u_qp[4]
    Gc, Gh, Gv, Ga = grad_qp[1], grad_qp[2], grad_qp[3], grad_qp[4]

    tau, dtau = crowding_factor((n + c + h + v) / Kk, Kk, ek)
    Ve, Ve_dc, Ve_dv = vascular_fraction(c, h, v)
    Ve_dh = Ve_dc
    Ua = a / (a + Ka)
    Ua_da = 1.0 / (a + Ka) - Ua / (a + Ka)

    dif_c = _gate(p["diffuse_c"], c > Lk, dtype)
    tax_c = _gate(p["taxis_c"], c > Lk, dtype)
    dif_h = _gate(p["diffuse_h"], h > Lk, dtype)
    tax_h = _gate(p["taxis_h"], h > Lk, dtype)
    dif_v = _gate(p["diffuse_v"], v > Lk, dtype)
    tax_v = _gate(p["taxis_v"], v > Lk, dtype)

    one = torch.ones_like(n)

    # ---------------- RHS: A (mass) and B (flux) ---------------------------
    A = (
        _add(n, _mul(dt2, _add(_mul(nec_c, c, n), _mul(nec_h, h, n),
                               _mul(nec_v, v, n), _mul(sw_h2n, 1.0 - Ve, h)))),
        _add(c, _mul(dt2, _add(_mul(prod_c, tau, c),
                               _neg(_mul(sw_c2h, 1.0 - Ve, c)),
                               _mul(sw_h2c, Ve, h),
                               _neg(_mul(nec_c, c, n))))),
        _add(h, _mul(dt2, _add(_mul(sw_c2h, 1.0 - Ve, c),
                               _neg(_mul(sw_h2c, Ve, h)),
                               _neg(_mul(nec_h, h, n)),
                               _neg(_mul(sw_h2n, 1.0 - Ve, h))))),
        _add(v, _mul(dt2, _add(_mul(prod_v, tau, Ua, v),
                               _neg(_mul(nec_v, v, n))))),
        _add(a, _mul(dt2, _add(_mul(sec_ac, c), _mul(sec_ah, h),
                               _neg(_mul(upt_av, v, a)),
                               _neg(_mul(dec_a, a))))),
    )
    B = (
        0.0,
        _mul(dt2, _add(_neg(_bvec(_mul(dif_c, tau), Gc)),
                       _neg(_bvec(_mul(tax_c, tau, c), Gv)))),
        _mul(dt2, _add(_neg(_bvec(_mul(dif_h, tau), Gh)),
                       _neg(_bvec(_mul(tax_h, tau, h), Gv)))),
        _mul(dt2, _add(_neg(_bvec(_mul(dif_v, tau), Gv)),
                       _neg(_bvec(_mul(tax_v, tau, v), Ga)))),
        0.0,
    )

    # ---------------- Jacobian blocks (src/pihna.C:571-747) ----------------
    nd = lambda x: _neg(_mul(dt2, x))  # the common "-DT_2 * (...)" wrapper
    C00 = _add(one, nd(_add(_mul(nec_c, c), _mul(nec_h, h), _mul(nec_v, v))))
    C01 = nd(_add(_mul(nec_c, n), _mul(sw_h2n, -Ve_dc, h)))
    C02 = nd(_add(_mul(nec_h, n), _mul(sw_h2n, -Ve_dh, h),
                  _mul(sw_h2n, 1.0 - Ve)))
    C03 = nd(_add(_mul(nec_v, n), _mul(sw_h2n, -Ve_dv, h)))

    C10 = nd(_add(_mul(prod_c, dtau, c), _neg(_mul(nec_c, c))))
    D10 = nd(_add(_neg(_bvec(_mul(dif_c, dtau), Gc)),
                  _neg(_bvec(_mul(tax_c, dtau, c), Gv))))
    C11 = _add(one, nd(_add(_mul(prod_c, tau), _mul(prod_c, dtau, c),
                            _neg(_mul(sw_c2h, 1.0 - Ve)),
                            _neg(_mul(sw_c2h, -Ve_dc, c)),
                            _mul(sw_h2c, Ve_dc, h),
                            _neg(_mul(nec_c, n)))))
    D11 = nd(_add(_neg(_bvec(_mul(dif_c, dtau), Gc)),
                  _neg(_bvec(_mul(tax_c, dtau, c), Gv)),
                  _neg(_bvec(_mul(tax_c, tau), Gv))))
    E11 = _mul(dt2, dif_c, tau)
    C12 = nd(_add(_mul(prod_c, dtau, c), _neg(_mul(sw_c2h, -Ve_dh, c)),
                  _mul(sw_h2c, Ve_dh, h), _mul(sw_h2c, Ve)))
    D12 = D10
    C13 = nd(_add(_mul(prod_c, dtau, c), _neg(_mul(sw_c2h, -Ve_dv, c)),
                  _mul(sw_h2c, Ve_dv, h)))
    D13 = D10
    E13 = _mul(dt2, tax_c, tau, c)

    C20 = nd(_neg(_mul(nec_h, h)))
    D20 = nd(_add(_neg(_bvec(_mul(dif_h, dtau), Gh)),
                  _neg(_bvec(_mul(tax_h, dtau, h), Gv))))
    C21 = nd(_add(_mul(sw_c2h, 1.0 - Ve), _mul(sw_c2h, -Ve_dc, c),
                  _neg(_mul(sw_h2c, Ve_dc, h)),
                  _neg(_mul(sw_h2n, -Ve_dc, h))))
    D21 = D20
    C22 = _add(one, nd(_add(_mul(sw_c2h, -Ve_dh, c),
                            _neg(_mul(sw_h2c, Ve_dh, h)),
                            _neg(_mul(sw_h2c, Ve)),
                            _neg(_mul(nec_h, n)),
                            _neg(_mul(sw_h2n, -Ve_dh, h)),
                            _neg(_mul(sw_h2n, 1.0 - Ve)))))
    D22 = nd(_add(_neg(_bvec(_mul(dif_h, dtau), Gh)),
                  _neg(_bvec(_mul(tax_h, dtau, h), Gv)),
                  _neg(_bvec(_mul(tax_h, tau), Gv))))
    E22 = _mul(dt2, dif_h, tau)
    C23 = nd(_add(_mul(sw_c2h, -Ve_dv, c), _neg(_mul(sw_h2c, Ve_dv, h)),
                  _neg(_mul(sw_h2n, -Ve_dv, h))))
    D23 = D20
    E23 = _mul(dt2, tax_h, tau, h)

    C30 = nd(_add(_mul(prod_v, dtau, Ua, v), _neg(_mul(nec_v, v))))
    D30 = nd(_add(_neg(_bvec(_mul(dif_v, dtau), Gv)),
                  _neg(_bvec(_mul(tax_v, dtau, v), Ga))))
    C31 = nd(_mul(prod_v, dtau, Ua, v))
    D31 = D30
    C32 = C31
    D32 = D30
    C33 = _add(one, nd(_add(_mul(prod_v, dtau, Ua, v),
                            _neg(_mul(nec_v, n)))))
    D33 = nd(_add(_neg(_bvec(_mul(dif_v, dtau), Gv)),
                  _neg(_bvec(_mul(tax_v, dtau, v), Ga)),
                  _neg(_bvec(_mul(tax_v, tau), Ga))))
    E33 = _mul(dt2, dif_v, tau)
    C34 = nd(_mul(prod_v, tau, Ua_da, v))
    E34 = _mul(dt2, tax_v, tau, v)

    C41 = nd(_mul(sec_ac, one))
    C42 = nd(_mul(sec_ah, one))
    C43 = nd(_neg(_mul(upt_av, a)))
    C44 = _add(one, nd(_add(_neg(_mul(upt_av, v)), _neg(_mul(dec_a, one)))))

    z = 0.0
    C = (
        (C00, C01, C02, C03, z),
        (C10, C11, C12, C13, z),
        (C20, C21, C22, C23, z),
        (C30, C31, C32, C33, C34),
        (z, C41, C42, C43, C44),
    )
    D = (
        (z, z, z, z, z),
        (D10, D11, D12, D13, z),
        (D20, D21, D22, D23, z),
        (D30, D31, D32, D33, z),
        (z, z, z, z, z),
    )
    E = (
        (z, z, z, z, z),
        (z, E11, z, E13, z),
        (z, z, E22, E23, z),
        (z, z, z, E33, E34),
        (z, z, z, z, z),
    )
    return WeakFormBlocks(A=A, B=B, C=C, D=D, E=E)


def pihna_physics(u_qp, grad_qp, fields, params) -> WeakForm:
    """The dense WeakForm of pihna_blocks, its structural zeros materialised:
    the `physics=` form of TransientRDCSystem's dense path
    (rdcfes_tpu/models/pihna.py:299-302)."""
    return pihna_blocks(u_qp, grad_qp, fields, params).to_dense()


def default_params():
    """Parameter defaults of the PIHNA input() (src/pihna.C:193-234), with
    the necrosis/* -> /Kappa_k scaling applied."""
    return {
        "dt": 1.0e-9,
        "cells_min_capacity": 0.0,
        "cells_max_capacity": 1.0,
        "cells_max_capacity_exponent": 1.0,
        "cytokines_max_capacity": 1.0,
        "necrosis_c": 0.0,
        "necrosis_h": 0.0,
        "necrosis_v": 0.0,
        "diffuse_c": 0.0,
        "taxis_c": 0.0,
        "diffuse_h": 0.0,
        "taxis_h": 0.0,
        "produce_c": 0.0,
        "switch_c2h": 0.0,
        "switch_h2c": 0.0,
        "switch_h2n": 0.0,
        "diffuse_v": 0.0,
        "taxis_v": 0.0,
        "produce_v": 0.0,
        "secrete_a_c": 0.0,
        "secrete_a_h": 0.0,
        "uptake_a_v": 0.0,
        "decay_a": 0.0,
    }
