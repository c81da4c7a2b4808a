"""Host-side mesh containers and generators (NumPy)."""

from .core import Mesh  # noqa: F401
from .generators import box_tet_mesh  # noqa: F401
