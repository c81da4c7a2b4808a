"""Adaptive mesh refinement's error indicator and flagging (host NumPy
copy of rdcfes_tpu.fem.amr, the same arrays).

The C++ reference's AMR is libMesh's KellyErrorEstimator,
`flag_elements_by_mean_stddev` and `refine_and_coarsen_elements`
(src/pihna.C:805-840).  Here:

  * `kelly_error_indicator`: the face-flux-jump indicator.  The jump of
    grad u . n is sampled at each interior face's centre from both
    elements, and (h_f / 24) area_f [[grad u . n]]^2 is summed over the
    interior faces and over the flagged variables into one vector (the
    shared ErrorVector of src/pihna.C:826-831);
  * `flag_by_mean_stddev`: refine where eta > mean + refine_frac std,
    coarsen where eta < mean - coarsen_frac std (libMesh's semantics).

The topology change is mesh/adapt.py (bisection), mesh/constrain.py
(1:8 with hanging-node constraints) or mesh/refine.py (uniform 1:8);
the PIHNA driver calls them between two time steps, with the state
taken off the device once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..mesh.core import ELEMENT_FACES, Mesh, element_neighbors
from .elements import shape_gradients


def _face_areas_normals_h(mesh: Mesh, elem: np.ndarray, side: np.ndarray):
    """Area, outward unit normal, and element size h for given (elem, side)
    pairs (host NumPy; topology is static)."""
    faces_def = ELEMENT_FACES[mesh.elem_type]
    fn = np.array([list(faces_def[s]) for s in side])  # (F, Kf)
    nodes = mesh.connectivity[elem[:, None], fn]  # (F, Kf)
    X = mesh.coords[nodes]  # (F, Kf, 3)
    if X.shape[1] == 3:  # triangle
        n = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
        area = 0.5 * np.linalg.norm(n, axis=1)
    else:  # quad: split into two triangles
        n1 = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
        n2 = np.cross(X[:, 2] - X[:, 0], X[:, 3] - X[:, 0])
        n = n1 + n2
        area = 0.5 * (np.linalg.norm(n1, axis=1) + np.linalg.norm(n2, axis=1))
    normal = n / np.linalg.norm(n, axis=1, keepdims=True)
    # element size h: cube root of volume (isotropic measure)
    h = np.cbrt(np.abs(mesh.element_volumes()))[elem]
    return area, normal, h


def interior_face_table(mesh: Mesh, return_sides: bool = False):
    """(elem_a, elem_b, area, normal, h_a[, side_a, side_b]) for every
    interior face, each face listed once (host precompute)."""
    nbr = element_neighbors(mesh.connectivity, mesh.elem_type)
    E, S = nbr.shape
    elems = np.repeat(np.arange(E), S)
    sides = np.tile(np.arange(S), E)
    other = nbr.reshape(-1)
    keep = other > elems  # interior faces once
    elems, sides, other = elems[keep], sides[keep], other[keep]
    area, normal, h = _face_areas_normals_h(mesh, elems, sides)
    if not return_sides:
        return elems, other, area, normal, h
    # neighbour's side index facing back (conforming: exactly one match)
    side_b = np.argmax(nbr[other] == elems[:, None], axis=1)
    return elems, other, area, normal, h, sides, side_b


def _face_center_gradients(mesh: Mesh, u: np.ndarray) -> np.ndarray:
    """Per-(element, side) physical gradients at the FACE CENTER:
    grad (E, S, V, 3), host NumPy.

    For trilinear HEX8 fields the gradient varies over the element, so the
    Kelly flux jump must be sampled on the face itself (libMesh's
    JumpErrorEstimator reinits a face FE on both sides); the face-center
    value is the one-point version of that face quadrature.  For affine
    TET4 this reproduces the constant gradient exactly."""
    faces_def = ELEMENT_FACES[mesh.elem_type]
    if mesh.elem_type == "HEX8":
        sx = np.array([-1, 1, 1, -1, -1, 1, 1, -1])
        sy = np.array([-1, -1, 1, 1, -1, -1, 1, 1])
        sz = np.array([-1, -1, -1, -1, 1, 1, 1, 1])
        ref = np.stack([sx, sy, sz], axis=1).astype(float)  # (8, 3)
    else:  # TET4 / TET10 reference vertices (+ Gmsh-order edge mids)
        ref = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
        if mesh.elem_type == "TET10":
            edges = [(0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)]
            ref = np.concatenate(
                [ref, 0.5 * (ref[[a for a, _ in edges]]
                             + ref[[b for _, b in edges]])], axis=0)
    pts = np.array([ref[list(f)].mean(axis=0) for f in faces_def])  # (S, 3)
    dN = shape_gradients(mesh.elem_type, pts)  # (S, K, 3)
    X = mesh.coords[mesh.connectivity]  # (E, K, 3)
    J = np.einsum("ekd,qkr->eqdr", X, dN)  # (E, S, 3, 3)
    Jinv = np.linalg.inv(J)  # (E, S, 3, 3): [r, d]
    dphi = np.einsum("qkr,eqrd->eqkd", dN, Jinv)  # (E, S, K, 3)
    ue = u[mesh.connectivity]  # (E, K, V)
    return np.einsum("eqkd,ekv->eqvd", dphi, ue)  # (E, S, V, 3)


def kelly_error_indicator(mesh: Mesh, u: np.ndarray,
                          variables: Sequence[int]) -> np.ndarray:
    """Per-element Kelly indicator eta (E,), accumulating the flagged
    variables into one vector (matching the shared-ErrorVector pattern of
    src/pihna.C:826-831).  The flux jump is sampled at each interior face's
    center from BOTH adjacent elements — exact for P1 TET4 (constant
    gradients) and first-order-correct for trilinear HEX8 and quadratic
    TET10 (a MixedMesh goes through mesh/adapt_ext.kelly_mixed)."""
    if mesh.dim == 2:
        # the reference's refusal (rdcfes_tpu/fem/amr.py:117-123); its
        # face-centre gradients take 3x3 Jacobians
        raise NotImplementedError(
            "Kelly error indicator supports 3D volume meshes only "
            "(TET4/TET10/HEX8); AMR is not wired for 2D TRI3/QUAD4 meshes")
    if mesh.elem_type not in ("TET4", "HEX8", "TET10"):
        # the reference's face-centre table has no quadratic hex nodes
        # and fails there with an IndexError
        raise NotImplementedError(
            f"Kelly error indicator supports TET4/TET10/HEX8 volume "
            f"meshes, not {mesh.elem_type}")
    ea, eb, area, normal, h, sa, sb = interior_face_table(mesh,
                                                          return_sides=True)
    grad = _face_center_gradients(mesh, np.asarray(u))  # (E, S, V, 3)
    eta2 = np.zeros(mesh.n_elems)
    for v in variables:
        jump = np.einsum(
            "fd,fd->f", grad[ea, sa, v] - grad[eb, sb, v], normal)
        contrib = (h / 24.0) * area * jump**2
        np.add.at(eta2, ea, contrib)
        np.add.at(eta2, eb, contrib)
    return np.sqrt(eta2)


def flag_by_mean_stddev(eta: np.ndarray, refine_fraction: float,
                        coarsen_fraction: float) -> Tuple[np.ndarray, np.ndarray]:
    """libMesh flag_elements_by_mean_stddev semantics: refine above
    mean + refine_fraction*std, coarsen below mean - coarsen_fraction*std."""
    mean = eta.mean()
    std = eta.std()
    refine = eta > mean + refine_fraction * std
    coarsen = eta < mean - coarsen_fraction * std
    return refine, coarsen
