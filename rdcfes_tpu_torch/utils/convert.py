"""Move meshes, coefficient blocks and solver state between NumPy and the
port, so both packages can be fed identical data.

The state dict is the one rdcfes_tpu's TransientRDCSystem.gather_state
returns: keys u, u_old, u_older, u_raw, each (N, V) float64.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..fem.weakform import WeakFormBlocks, _is_zero
from ..mesh.core import Mesh


def state_from_numpy(gstate: Dict[str, np.ndarray], device,
                     dtype: torch.dtype = torch.float64
                     ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in gstate.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def mesh_from_arrays(coords: np.ndarray, connectivity: np.ndarray,
                     elem_type: str,
                     subdomain_id: Optional[np.ndarray] = None) -> Mesh:
    return Mesh(coords=np.asarray(coords), connectivity=np.asarray(
        connectivity), elem_type=elem_type, subdomain_id=subdomain_id)


def blocks_from_numpy(A, B, C, D, E, device,
                      dtype: torch.dtype = torch.float64) -> WeakFormBlocks:
    """WeakFormBlocks from nested sequences of NumPy planes; a Python 0.0
    entry stays structurally absent."""
    f = lambda x: x if _is_zero(x) else torch.as_tensor(
        np.asarray(x), dtype=dtype, device=device)
    return WeakFormBlocks(
        A=tuple(f(a) for a in A),
        B=tuple(f(b) for b in B),
        C=tuple(tuple(f(c) for c in row) for row in C),
        D=tuple(tuple(f(d) for d in row) for row in D),
        E=tuple(tuple(f(e) for e in row) for row in E),
    )
