"""Model physics as block-sparse weak forms."""

from . import response
from .adpm import ADPM_VARS, adpm_physics
from .hcc import HCC_VARS, hcc_physics
from .pihna import PIHNA_VARS, pihna_physics
from .proteas import PROTEAS_VARS, proteas_physics
from .ripf import RIPF_VARS, ripf_physics

__all__ = [
    "response",
    "pihna_physics", "PIHNA_VARS",
    "adpm_physics", "ADPM_VARS",
    "proteas_physics", "PROTEAS_VARS",
    "ripf_physics", "RIPF_VARS",
    "hcc_physics", "HCC_VARS",
]
