"""Application drivers, one per driver of the C++ reference
(src/main.C:28-57): PIHNA, ADPM, PROTEAS, RIPF, the solid, the coupled
HCC and process_mesh.

Each transient or solid driver reads a GetPot deck, builds its system,
runs the time (or load) loop, and writes the reference's artifacts
(processed Gmsh copy, VTU/PVD time series, CSV science metrics) into the
results directory; process_mesh transforms a mesh on the host.
"""

from . import adpm, coupled_hcc, pihna, process_mesh, proteas, ripf, solid

__all__ = ["pihna", "adpm", "proteas", "ripf", "solid", "coupled_hcc",
           "process_mesh"]
