"""Move meshes, coefficient blocks, material tables, positions and solver
state between NumPy and the port, so both packages can be fed identical
data.

The state dict is the one rdcfes_tpu's TransientRDCSystem.gather_state
returns: keys u, u_old, u_older, u_raw, each (N, V) float64.  Solid
positions are (N, 3) float64.
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


def mesh_from_reference(mesh) -> Mesh:
    """A port Mesh holding copies of another single-type mesh's arrays
    (e.g. an rdcfes_tpu Mesh): coordinates, connectivity, subdomain ids,
    boundary faces with their elements, sides and ids."""
    arr = lambda name: np.array(getattr(mesh, name))
    return Mesh(coords=arr("coords"), connectivity=arr("connectivity"),
                elem_type=mesh.elem_type, subdomain_id=arr("subdomain_id"),
                boundary_faces=arr("boundary_faces"),
                boundary_elem=arr("boundary_elem"),
                boundary_side=arr("boundary_side"),
                boundary_id=arr("boundary_id"))


def material_tables(subdomain_id: np.ndarray,
                    materials: Dict[int, Dict[str, float]],
                    fibres: Optional[np.ndarray] = None
                    ) -> Dict[str, np.ndarray]:
    """Per-element solid material tables from a subdomain-keyed deck, with
    the reference's defaults (young 1e3, poisson 0.3, no fibre stiffness,
    no growth): young, poisson, fibre_k (E,); rates, fibres (E, 3)."""
    sid = np.asarray(subdomain_id)
    E = sid.shape[0]
    young = np.full(E, 1.0e3)
    poisson = np.full(E, 0.3)
    fibre_k = np.zeros(E)
    rates = np.zeros((E, 3))
    for s, mat in materials.items():
        sel = sid == s
        young[sel] = mat.get("young", 1.0e3)
        poisson[sel] = mat.get("poisson", 0.3)
        fibre_k[sel] = mat.get("fibre_stiffness", 0.0)
        for d in range(3):
            rates[sel, d] = mat.get(f"stretch_rate_{d}", 0.0)
    fib = np.zeros((E, 3)) if fibres is None else np.array(
        fibres, dtype=np.float64)
    return {"young": young, "poisson": poisson, "fibre_k": fibre_k,
            "rates": rates, "fibres": fib}


def positions_from_numpy(x: np.ndarray, device,
                         dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Solid positions (N, 3) as a tensor."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def positions_to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


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
