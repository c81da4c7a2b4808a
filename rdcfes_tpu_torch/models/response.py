"""Parametric response functions on tensors (branchless torch.where
chains; counterparts of rdcfes_tpu.models.response).

Vectorized equivalents of the scalar helpers in the reference app
(src/utils.h:100-229): rectangular pulse `pi_`, step-decay `sd_`,
step-growth `sg_`, trapezoid `tr_`, Boltzmann sigmoid increase/decrease
`bsi_`/`bsd_`, each with its analytic derivative.  Semantics match the
reference exactly, including the quirks:

* a non-positive magnitude parameter cM disables the function entirely
* `bsi_`/`bsd_` do NOT scale by cM: cM only gates them on/off
  (src/utils.h:190-198, 210-219)
* derivatives of the piecewise-constant `pi_` are zero a.e. (callers in the
  reference never use a `deriv_Pi_`)

The where-chains mirror the reference's strict `<` comparisons so branch
boundaries land on identical sides.  C is a tensor; the parameters p are
Python floats (deck scalars) or tensors broadcastable against C.  Results
keep C's dtype and device.
"""

from __future__ import annotations

import torch


def _gated(cM, val: torch.Tensor) -> torch.Tensor:
    """val where cM > 0, else 0 (cM a Python number or a tensor)."""
    if isinstance(cM, torch.Tensor):
        return torch.where(cM <= 0.0, torch.zeros_like(val), val)
    return torch.zeros_like(val) if cM <= 0.0 else val


def _chain(C: torch.Tensor, *pairs_then_else):
    """where(C < c0, v0, where(C < c1, v1, ... else)) with every value
    brought to C's dtype first (two Python scalars in one torch.where
    would otherwise come back in the default dtype)."""
    *pairs, last = pairs_then_else
    like = lambda v: v if isinstance(v, torch.Tensor) else torch.full_like(
        C, v)
    out = like(last)
    for bound, val in reversed(pairs):
        out = torch.where(C < bound, like(val), out)
    return out


def pi_(C, p):
    """Rectangular function: cM on [c0, c1), else 0."""
    cM, c0, c1 = p[0], p[1], p[2]
    return _gated(cM, _chain(C, (c0, 0.0), (c1, cM), 0.0))


def sd_(C, p):
    """Step-decay: cM below c0, linear ramp down to 0 at c1."""
    cM, c0, c1 = p[0], p[1], p[2]
    return _gated(cM, _chain(C, (c0, cM), (c1, cM * (c1 - C) / (c1 - c0)),
                             0.0))


def deriv_sd_(C, p):
    cM, c0, c1 = p[0], p[1], p[2]
    return _gated(cM, _chain(C, (c0, 0.0), (c1, -cM / (c1 - c0)), 0.0))


def sg_(C, p):
    """Step-growth: cM below c0, linear ramp cM*(C-c0)/(c1-c0) to c1,
    then 0."""
    cM, c0, c1 = p[0], p[1], p[2]
    return _gated(cM, _chain(C, (c0, cM), (c1, cM * (C - c0) / (c1 - c0)),
                             0.0))


def deriv_sg_(C, p):
    cM, c0, c1 = p[0], p[1], p[2]
    return _gated(cM, _chain(C, (c0, 0.0), (c1, cM / (c1 - c0)), 0.0))


def tr_(C, p):
    """Trapezoid: ramp up on [c0,c1), plateau cM on [c1,c2), ramp down on
    [c2,c3)."""
    cM, c0, c1, c2, c3 = p[0], p[1], p[2], p[3], p[4]
    return _gated(cM, _chain(
        C, (c0, 0.0), (c1, cM * (C - c0) / (c1 - c0)), (c2, cM),
        (c3, cM * (c3 - C) / (c3 - c2)), 0.0))


def deriv_tr_(C, p):
    cM, c0, c1, c2, c3 = p[0], p[1], p[2], p[3], p[4]
    return _gated(cM, _chain(
        C, (c0, 0.0), (c1, cM / (c1 - c0)), (c2, 0.0),
        (c3, -cM / (c3 - c2)), 0.0))


def _boltzmann(C, C0, dC):
    return torch.exp((C - C0) / dC)


def bsi_(C, p):
    """Boltzmann sigmoid increase G/(1+G); gated (not scaled) by cM > 0."""
    cM, C0, dC = p[0], p[1], p[2]
    G = _boltzmann(C, C0, dC)
    return _gated(cM, G / (1.0 + G))


def deriv_bsi_(C, p):
    cM, C0, dC = p[0], p[1], p[2]
    G = _boltzmann(C, C0, dC)
    return _gated(cM, G / (dC * (1.0 + G) ** 2))


def bsd_(C, p):
    """Boltzmann sigmoid decrease 1/(1+G); gated (not scaled) by cM > 0."""
    cM, C0, dC = p[0], p[1], p[2]
    G = _boltzmann(C, C0, dC)
    return _gated(cM, 1.0 / (1.0 + G))


def deriv_bsd_(C, p):
    cM, C0, dC = p[0], p[1], p[2]
    G = _boltzmann(C, C0, dC)
    return _gated(cM, -G / (dC * (1.0 + G) ** 2))


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """1 for x > 0 else 0 (src/utils.h:84)."""
    return (x > 0.0).to(x.dtype)
