"""Application drivers, one per driver of the C++ reference
(src/main.C:28-57) whose system is ported: PIHNA, ADPM and the solid.

Each reads a GetPot deck, builds its system, runs the time (or load)
loop, and writes the reference's artifacts (processed Gmsh copy, VTU/PVD
time series, CSV science metrics) into the results directory.  PROTEAS,
RIPF, coupled HCC and process_mesh wait for ROADMAP queue 1 items 10, 12
and 16.
"""

from . import adpm, pihna, solid

__all__ = ["pihna", "adpm", "solid"]
