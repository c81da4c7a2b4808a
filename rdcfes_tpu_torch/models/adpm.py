"""ADPM: 3-species Alzheimer's disease progression model, block-sparse weak
form in torch (counterpart of rdcfes_tpu.models.adpm, itself from
src/adpm.C:324-652).

Species PrP (normal prion protein), A_b (amyloid-beta), Tau (tau protein),
with

* response-function-driven reaction terms: trapezoid transform Tr_,
  step-decay production SD_, rectangular-pulse gating Pi_ for
  decay/diffusion/taxis (src/adpm.C:497-530; models.response)
* time-weighted PrP decay: decay coefficient scaled by time^gamma
  (src/adpm.C:368-369)
* fibre-tract-aligned anisotropic taxis with an angular tolerance gate:
  the taxis drift direction is +/- the element's tract vector when the
  (normalized) concentration gradient is within `taxis/<s>/angle` of it,
  else zero (src/adpm.C:473-492)

The Jacobian keeps only the terms the reference keeps (src/adpm.C:532-591);
the dropped ones are derivatives of piecewise-constant response functions
or of the tract gating, which vanish almost everywhere.

`fields` must contain "tracts": (E, 3) tensor of per-element fibre vectors
on the system's device, and "time": the simulation time as a Python float.

`params` keys (plain Python floats): dt, decay_PrP, decay_PrP_pulse0,
decay_PrP_pulse1, decay_PrP_time_exponent, transform_A_b,
transform_A_b_t0..t3, transform_Tau, transform_Tau_t0..t3,
diffuse_A_b(+_pulse0/1), taxis1_A_b(+_pulse0/1), taxis2_A_b(+_pulse0/1),
produce_A_b(+_s0/_s1), decay_A_b(+_pulse0/1), same for Tau, omega_A_b,
omega_Tau (cosines of the tolerance angles).

A response function whose AMPLITUDE parameter is the Python float 0.0 stays
a structural zero, so its blocks never reach a kernel.  `adpm_physics`
(the dense stacked form) belongs to the assembled path and is not here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.weakform import WeakForm, WeakFormBlocks
from . import response as rf

ADPM_VARS = ("PrP", "A_b", "Tau")


def _triple(p, stem):
    return (p[stem], p[stem + "_pulse0"], p[stem + "_pulse1"])


def _sigmoid3(p, stem):
    return (p[stem], p[stem + "_s0"], p[stem + "_s1"])


def _trapezoid5(p, stem):
    return (p[stem], p[stem + "_t0"], p[stem + "_t1"], p[stem + "_t2"],
            p[stem + "_t3"])


def tract_gate(grad: torch.Tensor, tracts_qp: torch.Tensor, omega: float
               ) -> torch.Tensor:
    """Gated taxis direction (src/adpm.C:477-492): +/- tract when the unit
    gradient aligns within the tolerance cosine `omega`, else zero.

    Channel-first: grad (Q, 3, E); tracts_qp (Q, 3, E) -> (Q, 3, E).  The
    thresholds flip on round-off, so the op order is the reference's:
    norm = sqrt(sum of squares), unit = grad / norm, d = sum(unit *
    tract)."""
    norm = torch.sqrt(torch.sum(grad * grad, dim=-2, keepdim=True))
    unit = grad / torch.where(norm == 0.0, 1.0, norm)
    d = torch.sum(unit * tracts_qp, dim=-2, keepdim=True)
    t = torch.where(d > omega, tracts_qp,
                    torch.where(d < -omega, -tracts_qp, 0.0))
    return torch.where(norm > 0.0, t, 0.0)


def _z(x) -> bool:
    return isinstance(x, (int, float)) and x == 0.0


def adpm_blocks(u_qp, grad_qp, fields, params) -> WeakFormBlocks:
    """Block-sparse weak form for ADPM: u_qp (3, Q, E), grad_qp
    (3, Q, 3, E) -> WeakFormBlocks."""
    p = params
    dt2 = p["dt"] / 2.0
    time = fields["time"]
    tracts = fields["tracts"]  # (E, 3)

    PrP, Ab, Ta = u_qp[0], u_qp[1], u_qp[2]
    GAb, GTa = grad_qp[1], grad_qp[2]
    Q, E = PrP.shape
    tracts_qp = tracts.T[None, :, :].expand(Q, 3, E)

    gamma = p["decay_PrP_time_exponent"]
    decay_PrP = (p["decay_PrP"] * time**gamma,
                 p["decay_PrP_pulse0"], p["decay_PrP_pulse1"])
    diffuse_Ab = _triple(p, "diffuse_A_b")
    taxis1_Ab = _triple(p, "taxis1_A_b")
    taxis2_Ab = _triple(p, "taxis2_A_b")
    produce_Ab = _sigmoid3(p, "produce_A_b")
    transform_Ab = _trapezoid5(p, "transform_A_b")
    decay_Ab = _triple(p, "decay_A_b")
    diffuse_Ta = _triple(p, "diffuse_Tau")
    taxis1_Ta = _triple(p, "taxis1_Tau")
    taxis2_Ta = _triple(p, "taxis2_Tau")
    produce_Ta = _sigmoid3(p, "produce_Tau")
    transform_Ta = _trapezoid5(p, "transform_Tau")
    decay_Ta = _triple(p, "decay_Tau")

    # amplitude-zero response functions are structural zeros; the PrP-decay
    # amplitude is scaled by time**gamma, which only preserves zero
    def pi(val, trip):
        return 0.0 if _z(trip[0]) else rf.pi_(val, trip)

    def sd(val, trip):
        return 0.0 if _z(trip[0]) else rf.sd_(val, trip)

    def dsd(val, trip):
        return 0.0 if _z(trip[0]) else rf.deriv_sd_(val, trip)

    def tr(val, t5):
        return 0.0 if _z(t5[0]) else rf.tr_(val, t5)

    def dtr(val, t5):
        return 0.0 if _z(t5[0]) else rf.deriv_tr_(val, t5)

    Tr_Ab = tr(Ab, transform_Ab)
    Tr_Ta = tr(Ta, transform_Ta)
    dTr_Ab = dtr(Ab, transform_Ab)
    dTr_Ta = dtr(Ta, transform_Ta)
    SD_Ab = sd(Ab, produce_Ab)
    SD_Ta = sd(Ta, produce_Ta)
    dSD_Ab = dsd(Ab, produce_Ab)
    dSD_Ta = dsd(Ta, produce_Ta)
    Pi_decay_PrP = 0.0 if _z(p["decay_PrP"]) else rf.pi_(PrP, decay_PrP)
    Pi_decay_Ab = pi(Ab, decay_Ab)
    Pi_decay_Ta = pi(Ta, decay_Ta)
    Pi_dif_Ab = pi(Ab, diffuse_Ab)
    Pi_dif_Ta = pi(Ta, diffuse_Ta)
    Pi_tax1_Ab = pi(Ab, taxis1_Ab)
    Pi_tax2_Ab = pi(Ta, taxis2_Ab)   # gated by Tau (src/adpm.C:514)
    Pi_tax1_Ta = pi(Ta, taxis1_Ta)
    Pi_tax2_Ta = pi(Ab, taxis2_Ta)   # gated by A_b (src/adpm.C:527)

    # tract gates are only needed when a taxis amplitude is live
    need_Ab_gate = not (_z(Pi_tax1_Ab) and _z(Pi_tax2_Ta))
    need_Ta_gate = not (_z(Pi_tax1_Ta) and _z(Pi_tax2_Ab))
    tract_Ab = (tract_gate(GAb, tracts_qp, p["omega_A_b"]) if need_Ab_gate
                else 0.0)
    tract_Ta = (tract_gate(GTa, tracts_qp, p["omega_Tau"]) if need_Ta_gate
                else 0.0)

    one = torch.ones_like(PrP)

    def m(*fs):
        for f in fs:
            if _z(f):
                return 0.0
        acc = fs[0]
        for f in fs[1:]:
            acc = acc * f
        return acc

    def add(*terms):
        live = [t for t in terms if not _z(t)]
        if not live:
            return 0.0
        acc = live[0]
        for t in live[1:]:
            acc = acc + t
        return acc

    def neg(x):
        return 0.0 if _z(x) else -x

    def bvec(coef, G):
        return 0.0 if (_z(coef) or _z(G)) else coef[..., None, :] * G

    z = 0.0
    A = (
        add(PrP, m(dt2, add(neg(m(Tr_Ab, PrP)), neg(m(Tr_Ta, PrP)),
                            neg(m(Pi_decay_PrP, PrP))))),
        add(Ab, m(dt2, add(m(SD_Ab, Ab), m(Tr_Ab, PrP),
                           neg(m(Pi_decay_Ab, Ab))))),
        add(Ta, m(dt2, add(m(SD_Ta, Ta), m(Tr_Ta, PrP),
                           neg(m(Pi_decay_Ta, Ta))))),
    )
    B = (
        z,
        m(dt2, add(neg(bvec(Pi_dif_Ab, GAb)),
                   neg(bvec(m(Pi_tax1_Ab, Ab), tract_Ab)),
                   bvec(m(Pi_tax2_Ab, Ab), tract_Ta))),
        m(dt2, add(neg(bvec(Pi_dif_Ta, GTa)),
                   neg(bvec(m(Pi_tax1_Ta, Ta), tract_Ta)),
                   bvec(m(Pi_tax2_Ta, Ta), tract_Ab))),
    )

    nd = lambda x: neg(m(dt2, x))
    C00 = add(one, nd(add(neg(Tr_Ab), neg(Tr_Ta), neg(Pi_decay_PrP))))
    C01 = nd(neg(m(dTr_Ab, PrP)))
    C02 = nd(neg(m(dTr_Ta, PrP)))
    C10 = nd(Tr_Ab)
    C11 = add(one, nd(add(SD_Ab, m(dSD_Ab, Ab), m(dTr_Ab, PrP),
                          neg(Pi_decay_Ab))))
    D11 = nd(add(neg(bvec(Pi_tax1_Ab, tract_Ab)),
                 bvec(Pi_tax2_Ab, tract_Ta)))
    E11 = m(dt2, Pi_dif_Ab)
    C20 = nd(Tr_Ta)
    C22 = add(one, nd(add(SD_Ta, m(dSD_Ta, Ta), m(dTr_Ta, PrP),
                          neg(Pi_decay_Ta))))
    D22 = nd(add(neg(bvec(Pi_tax1_Ta, tract_Ta)),
                 bvec(Pi_tax2_Ta, tract_Ab)))
    E22 = m(dt2, Pi_dif_Ta)

    C = ((C00, C01, C02), (C10, C11, z), (C20, z, C22))
    D = ((z, z, z), (z, D11, z), (z, z, D22))
    Emat = ((z, z, z), (z, E11, z), (z, z, E22))
    return WeakFormBlocks(A=A, B=B, C=C, D=D, E=Emat)


def adpm_physics(u_qp, grad_qp, fields, params) -> WeakForm:
    """The dense WeakForm of adpm_blocks, its structural zeros materialised:
    the `physics=` form of TransientRDCSystem's dense path
    (rdcfes_tpu/models/adpm.py:220-223)."""
    return adpm_blocks(u_qp, grad_qp, fields, params).to_dense()


def default_params():
    """Defaults of the ADPM input() (src/adpm.C:169-225); omega_* are cosines
    of the tolerance angles (default 89.9 degrees)."""
    d = {
        "dt": 1.0e-9,
        "decay_PrP": 0.0, "decay_PrP_pulse0": -1.0e-20,
        "decay_PrP_pulse1": 1.0e20, "decay_PrP_time_exponent": 0.0,
        "transform_A_b": 0.0, "transform_A_b_t0": -1.1e-20,
        "transform_A_b_t1": -1.0e-20, "transform_A_b_t2": 1.0e20,
        "transform_A_b_t3": 1.1e20,
        "transform_Tau": 0.0, "transform_Tau_t0": -1.1e-20,
        "transform_Tau_t1": -1.0e-20, "transform_Tau_t2": 1.0e20,
        "transform_Tau_t3": 1.1e20,
        "omega_A_b": float(np.cos(np.deg2rad(89.9))),
        "omega_Tau": float(np.cos(np.deg2rad(89.9))),
    }
    for s in ("A_b", "Tau"):
        d.update({
            f"diffuse_{s}": 0.0, f"diffuse_{s}_pulse0": -1.0e-20,
            f"diffuse_{s}_pulse1": 1.0e20,
            f"taxis1_{s}": 0.0, f"taxis1_{s}_pulse0": -1.0e-20,
            f"taxis1_{s}_pulse1": 1.0e20,
            f"taxis2_{s}": 0.0, f"taxis2_{s}_pulse0": -1.0e-20,
            f"taxis2_{s}_pulse1": 1.0e20,
            f"produce_{s}": 0.0, f"produce_{s}_s0": 1.0e20,
            f"produce_{s}_s1": 1.1e20,
            f"decay_{s}": 0.0, f"decay_{s}_pulse0": -1.0e-20,
            f"decay_{s}_pulse1": 1.0e20,
        })
    return d
