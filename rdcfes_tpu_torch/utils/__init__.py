"""Scalar helpers, checkpoints, device selection, NumPy conversion and
inverse-distance interpolation."""

from . import scalars
from .checkpoint import load_checkpoint, save_checkpoint
from .ida import inverse_distance_interpolate

__all__ = ["save_checkpoint", "load_checkpoint",
           "inverse_distance_interpolate", "scalars"]
