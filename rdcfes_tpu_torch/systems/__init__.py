"""Time-stepping systems."""

from .transient import TransientRDCSystem, clamp_nonnegative  # noqa: F401
