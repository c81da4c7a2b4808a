"""Finite-element layer: element tables, geometry, weak forms, assembly,
block-sparse operators and the CUDA kernels of the qp path
(fem/kernels.py)."""

from . import elements
from .assembly import (NodePairSparsity, assemble_matrix, assemble_vector,
                       build_sparsity, interpolate_at_qp)
from .bcsr import bcsr_matvec, extract_diagonal_blocks
from .geometry import face_geometry_factors, geometry_factors
from .weakform import WeakForm, element_matrices, element_vectors

__all__ = [
    "elements",
    "geometry_factors",
    "face_geometry_factors",
    "WeakForm",
    "element_vectors",
    "element_matrices",
    "NodePairSparsity",
    "build_sparsity",
    "assemble_matrix",
    "assemble_vector",
    "interpolate_at_qp",
    "bcsr_matvec",
    "extract_diagonal_blocks",
]
