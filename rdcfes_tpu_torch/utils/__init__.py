"""Scalar helpers, device selection, NumPy conversion and inverse-distance
interpolation."""

from .ida import inverse_distance_interpolate

__all__ = ["inverse_distance_interpolate"]
