"""Time-stepping and load-stepping systems."""

from .mixed import MixedTransientRDCSystem
from .solid import SolidBC, SolidSystem
from .transient import TransientRDCSystem, clamp_nonnegative

__all__ = ["TransientRDCSystem", "MixedTransientRDCSystem",
           "clamp_nonnegative", "SolidSystem", "SolidBC"]
