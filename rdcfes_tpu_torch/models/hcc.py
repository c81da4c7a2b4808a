"""HCC: 3-species hepatocellular-carcinoma transport model, the RDC half of
the coupled driver; block-sparse weak form in torch (counterpart of
rdcfes_tpu.models.hcc, itself from src/coupled_hcc.C:414-649).

Species l (liver/host), c (tumour), n (necrotic), assembled every step on
the current deformed geometry (the coupled driver rebuilds the geometry
factors from the moved coordinates), with

* crowding Tau = (1 - (l+c+n)/Kappa_k)^ek with clamped branches, as
  PIHNA's (src/coupled_hcc.C:510-532)
* threshold gating of tumour diffusion and mechano-taxis at Lambda_k
  (src/coupled_hcc.C:534-535)
* mechano-taxis drift along GRAD_sigma, which the C++ reference
  scaffolds but never feeds (GRAD_sigma is the zero vector,
  src/coupled_hcc.C:508): its terms are structurally absent unless a
  "grad_sigma" field (Q, 3, E) is given.

The reference's anomalies are kept, as the reference package keeps them:
Ke[0][1], Ke[0][2] and Ke[1][0] carry a spurious phi_j phi_i capacity
term (src/coupled_hcc.C:577-597), and the second Ke[1][1] accumulation
(src/coupled_hcc.C:611-619, meant as Ke[1][2]) lands in Ke[1][1], so
C11 and D11 carry it twice and Ke[1][2] stays empty.

`params` keys: dt, cells_min_capacity, cells_max_capacity,
cells_max_capacity_exponent, produce_l, diffuse_c, mechano_c, produce_c,
necrosis_l, necrosis_c, necrosis_pressure (the necrosis_* values already
divided by Kappa_k, src/coupled_hcc.C:459-461; necrosis_pressure is read
and unused, as in the reference).  `hcc_physics`, the dense stacked form,
belongs to the assembled path and is not here.
"""

from __future__ import annotations

import torch

from ..fem.weakform import WeakForm, WeakFormBlocks
from .pihna import _add, _bvec, _gate, _mul, _neg, crowding_factor

HCC_VARS = ("l", "c", "n")


def hcc_blocks(u_qp: torch.Tensor, grad_qp: torch.Tensor, fields, params
               ) -> WeakFormBlocks:
    """Block-sparse weak form for HCC from u_qp (3, Q, E) and grad_qp
    (3, Q, 3, E); every formula is the reference's, anomalies included.
    The unconditional `one` terms keep C00-C22's blocks live whatever the
    deck says."""
    p = params
    dt2 = p["dt"] / 2.0
    Lk = p["cells_min_capacity"]
    Kk = p["cells_max_capacity"]
    ek = p["cells_max_capacity_exponent"]
    prod_l, prod_c = p["produce_l"], p["produce_c"]
    nec_l, nec_c = p["necrosis_l"], p["necrosis_c"]
    dtype = u_qp.dtype

    l, c, n = u_qp[0], u_qp[1], u_qp[2]
    Gc = grad_qp[1]
    Gsig = fields.get("grad_sigma")

    tau, dtau = crowding_factor((l + c + n) / Kk, Kk, ek)
    dif_c = _gate(p["diffuse_c"], c > Lk, dtype)
    mech_c = _gate(p["mechano_c"], c > Lk, dtype)
    one = torch.ones_like(l)

    def bsig(coef):
        return 0.0 if Gsig is None else _bvec(coef, Gsig)

    # ---------------- RHS (src/coupled_hcc.C:539-564) ---------------------
    A = (
        _add(l, _mul(dt2, _add(_mul(prod_l, tau, l),
                               _neg(_mul(nec_l, l, n))))),
        _add(c, _mul(dt2, _add(_mul(prod_c, tau, c),
                               _neg(_mul(nec_c, c, n))))),
        _add(n, _mul(dt2, _add(_mul(nec_l, l, n), _mul(nec_c, c, n)))),
    )
    B = (
        0.0,
        _mul(dt2, _add(_neg(_bvec(_mul(dif_c, tau), Gc)),
                       _neg(bsig(_mul(mech_c, tau, c))))),
        0.0,
    )

    # ---------------- Jacobian with anomalies (src/coupled_hcc.C:566-637) -
    nd = lambda x: _neg(_mul(dt2, x))
    C00 = _add(one, nd(_add(_mul(prod_l, tau), _mul(prod_l, dtau, l),
                            _neg(_mul(nec_l, n)))))
    C01 = _add(one, nd(_mul(prod_l, dtau, l)))          # spurious capacity
    C02 = _add(one, nd(_add(_mul(prod_l, dtau, l),      # spurious capacity
                            _neg(_mul(nec_l, l)))))
    C10 = _add(one, nd(_mul(prod_c, dtau, c)))          # spurious capacity
    # Ke[1][1] = intended block + the misplaced "[1][2]" accumulation
    C11 = _add(one, nd(_add(_mul(prod_c, tau), _mul(prod_c, dtau, c),
                            _neg(_mul(nec_c, n)))),
               one, nd(_add(_mul(prod_c, dtau, c),
                            _neg(_mul(nec_c, c)))))
    C20 = nd(_mul(nec_l, n))
    C21 = nd(_mul(nec_c, n))
    C22 = _add(one, nd(_add(_mul(nec_l, l), _mul(nec_c, c))))

    Dtau_c = _mul(dt2, _add(_bvec(_mul(dif_c, dtau), Gc),
                            bsig(_mul(mech_c, dtau, c))))
    D11 = _add(_mul(dt2, _add(_bvec(_mul(dif_c, dtau), Gc),
                              bsig(_mul(mech_c, dtau, c)),
                              bsig(_mul(mech_c, tau)))),
               Dtau_c)
    E11 = _mul(dt2, dif_c, tau)

    return WeakFormBlocks(
        A=A, B=B,
        C=((C00, C01, C02), (C10, C11, 0.0), (C20, C21, C22)),
        D=((0.0, 0.0, 0.0), (Dtau_c, D11, 0.0), (0.0, 0.0, 0.0)),
        E=((0.0, 0.0, 0.0), (0.0, E11, 0.0), (0.0, 0.0, 0.0)),
    )


def hcc_physics(u_qp, grad_qp, fields, params) -> WeakForm:
    """The dense WeakForm of hcc_blocks, its structural zeros materialised:
    the `physics=` form of TransientRDCSystem's dense path
    (rdcfes_tpu/models/hcc.py:52-132, a dense form of the same formulas)."""
    return hcc_blocks(u_qp, grad_qp, fields, params).to_dense()


def default_params():
    """Defaults of the coupled_hcc input() (src/coupled_hcc.C:350-370)."""
    return {
        "dt": 1.0,
        "cells_min_capacity": 0.0,
        "cells_max_capacity": 1.0,
        "cells_max_capacity_exponent": 1.0,
        "produce_l": 0.0,
        "diffuse_c": 0.0,
        "mechano_c": 0.0,
        "produce_c": 0.0,
        "necrosis_l": 0.0,
        "necrosis_c": 0.0,
        "necrosis_pressure": 0.0,
    }
