"""Host-side mesh containers, generators and adaptation (NumPy)."""

from . import gmsh, transform
from .adapt import AdaptiveMesh, AdaptOutcome, adapt_flagged
from .constrain import ConstrainedAdaptResult, ConstrainedMesh
from .core import ELEMENT_FACES, Mesh, extract_boundary_faces
from .generators import box_hex_mesh, box_tet_mesh
from .refine import Refinement, refine_flagged, refine_uniform

__all__ = [
    "Mesh",
    "ELEMENT_FACES",
    "extract_boundary_faces",
    "box_hex_mesh",
    "box_tet_mesh",
    "refine_uniform",
    "refine_flagged",
    "AdaptiveMesh",
    "AdaptOutcome",
    "adapt_flagged",
    "ConstrainedAdaptResult",
    "ConstrainedMesh",
    "Refinement",
    "gmsh",
    "transform",
]
