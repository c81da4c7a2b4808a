"""Time-stepping and load-stepping systems."""

from .solid import SolidSystem  # noqa: F401
from .transient import TransientRDCSystem, clamp_nonnegative  # noqa: F401
