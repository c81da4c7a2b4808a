"""Move meshes (single-type and mixed), weak forms (block and dense),
material tables, positions, step fields and solver state between NumPy
and the port, so both packages can be fed identical data.

The state dict is the one rdcfes_tpu's TransientRDCSystem.gather_state
returns: keys u, u_old, u_older, u_raw, each (N, V) in the system's
dtype (float64, or float32 in the serving mode: pass dtype= so that both
packages step the same f32 values).  Solid positions are (N, 3) float64.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..fem.weakform import WeakForm, WeakFormBlocks, _is_zero
from ..mesh.core import Mesh, MeshBlock, MixedMesh


def state_from_numpy(gstate: Dict[str, np.ndarray], device,
                     dtype: torch.dtype = torch.float64
                     ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in gstate.items()}


def fields_from_numpy(fields: Dict, device,
                      dtype: torch.dtype = torch.float64) -> Dict:
    """The `fields` of a transient step moved across: arrays (e.g. ADPM's
    tracts (E, 3)) become tensors on `device`, scalars (e.g. "time")
    become Python floats."""
    out = {}
    for k, v in fields.items():
        a = np.asarray(v)
        out[k] = (float(a) if a.ndim == 0
                  else torch.as_tensor(np.array(a), dtype=dtype,
                                       device=device))
    return out


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def mesh_from_arrays(coords: np.ndarray, connectivity: np.ndarray,
                     elem_type: str,
                     subdomain_id: Optional[np.ndarray] = None) -> Mesh:
    return Mesh(coords=np.asarray(coords), connectivity=np.asarray(
        connectivity), elem_type=elem_type, subdomain_id=subdomain_id)


def mixed_mesh_from_arrays(coords: np.ndarray, blocks) -> MixedMesh:
    """A port MixedMesh from coords (N, 3) and blocks, a sequence of
    (elem_type, connectivity (Eb, Kb), subdomain_id (Eb,) or None)."""
    return MixedMesh(coords=np.array(coords), blocks=[
        MeshBlock(t, np.array(conn), None if sid is None else np.array(sid))
        for t, conn, sid in blocks])


def mesh_from_reference(mesh):
    """A port Mesh (or MixedMesh) holding copies of another mesh's arrays
    (e.g. an rdcfes_tpu Mesh or MixedMesh): coordinates, connectivity (a
    MixedMesh's per block), subdomain ids, boundary faces with their
    (blocks,) elements, sides and ids."""
    arr = lambda name: np.array(getattr(mesh, name))
    if mesh.elem_type == "MIXED":
        return MixedMesh(
            coords=arr("coords"),
            blocks=[MeshBlock(b.elem_type, np.array(b.connectivity),
                              np.array(b.subdomain_id))
                    for b in mesh.blocks],
            boundary_faces=arr("boundary_faces"),
            boundary_block=arr("boundary_block"),
            boundary_elem=arr("boundary_elem"),
            boundary_side=arr("boundary_side"),
            boundary_id=arr("boundary_id"))
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


def weakform_from_numpy(wf, device,
                        dtype: torch.dtype = torch.float64) -> WeakForm:
    """The port's WeakForm from any object with fields A..E of NumPy-
    convertible arrays or None (e.g. an rdcfes_tpu WeakForm)."""
    f = lambda x: None if x is None else torch.as_tensor(
        np.asarray(x), dtype=dtype, device=device)
    return WeakForm(A=f(wf.A), B=f(wf.B), C=f(wf.C), D=f(wf.D), E=f(wf.E))
