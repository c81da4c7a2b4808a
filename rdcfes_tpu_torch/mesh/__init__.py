"""Host-side mesh containers, generators and adaptation (NumPy)."""

from . import gmsh, transform
from .adapt import AdaptiveMesh, AdaptOutcome, adapt_flagged
from .adapt_ext import (MixedAdaptOutcome, MixedConstrained, Tet10Adaptive,
                        kelly_mixed, quadratic_transfer, tet10_skeleton)
from .constrain import ConstrainedAdaptResult, ConstrainedMesh
from .core import (ELEMENT_FACES, Mesh, MeshBlock, MixedMesh,
                   element_blocks, extract_boundary_faces)
from .generators import (box_hex_mesh, box_mixed_mesh, box_quad_mesh,
                         box_tet_mesh, box_tri_mesh, tet4_to_tet10)
from .refine import Refinement, refine_flagged, refine_uniform

__all__ = [
    "Mesh",
    "MeshBlock",
    "MixedMesh",
    "ELEMENT_FACES",
    "element_blocks",
    "extract_boundary_faces",
    "box_hex_mesh",
    "box_tet_mesh",
    "box_mixed_mesh",
    "box_quad_mesh",
    "box_tri_mesh",
    "tet4_to_tet10",
    "refine_uniform",
    "refine_flagged",
    "AdaptiveMesh",
    "AdaptOutcome",
    "adapt_flagged",
    "ConstrainedAdaptResult",
    "ConstrainedMesh",
    "MixedAdaptOutcome",
    "MixedConstrained",
    "Tet10Adaptive",
    "kelly_mixed",
    "quadratic_transfer",
    "tet10_skeleton",
    "Refinement",
    "gmsh",
    "transform",
]
