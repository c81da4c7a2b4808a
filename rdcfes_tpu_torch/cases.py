"""Synthetic PIHNA and ADPM case directories (the files of
rdcfes_tpu.cases.make_pihna_case and make_adpm_case for single-type TET4
meshes of order 1, byte for byte, except that the Makefile launches
rdcfes_tpu_torch.cli).

The patient meshes of the C++ reference's run/ cases are not in the
repository, so runs at patient scale need stand-ins: each function writes
a complete case directory (Gmsh mesh, nodal/elemental IC `.dat` files,
`input.dat` deck and a Makefile) at the documented case size.  Mixed and
second-order cases come with ROADMAP queue 1 item 13; the PROTEAS, RIPF
and HCC cases with their drivers (items 10 and 12).
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import box_tet_mesh, gmsh


def _write_makefile(directory: str, args: str) -> None:
    """The reference's run harness: each case dir ships a Makefile whose
    `run` target launches the solver and tees stdout to output.txt
    (run/PIHNA/Makefile:6)."""
    with open(os.path.join(directory, "Makefile"), "w") as f:
        f.write(
            "default: run\n"
            "#\n"
            "run:\n"
            f"\tpython3 -m rdcfes_tpu_torch.cli {args} 2>&1 | tee output.txt\n"
            "#\n"
            "clean:\n"
            "\trm -rf simulation output.txt\n"
        )


def _brain_mesh(n: int = 28):
    """~24k nodes / ~132k TET4 over a 150x180x150 mm box (the run/PIHNA
    patient mesh is 24,903 nodes / 134,646 elements)."""
    return box_tet_mesh(n, n, n, bounds=((0, 150.0), (0, 180.0), (0, 150.0)))


def make_pihna_case(directory: str, n: int = 28, seed: int = 0,
                    n_steps: int = 120) -> str:
    """Synthetic PIHNA glioma case (deck values = run/PIHNA/input.dat) on
    box_tet_mesh(n, n, n) with brain bounds."""
    os.makedirs(directory, exist_ok=True)
    mesh = _brain_mesh(n)
    gmsh.write(mesh, os.path.join(directory, "Brain_Model.msh"))

    rng = np.random.default_rng(seed)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0 = np.zeros((mesh.n_nodes, 5))
    # magnitudes follow the deck's own range thresholds
    # (active_tumor/min = 500, vascularity/min = 7200)
    u0[:, 1] = 2000.0 * np.exp(-r2 / (2 * 25.0**2))          # normoxic seed
    u0[:, 2] = 500.0 * np.exp(-r2 / (2 * 30.0**2))           # hypoxic rim
    u0[:, 3] = 7200.0 * (1.0 + 0.1 * rng.random(mesh.n_nodes))  # vasculature
    u0[:, 4] = 1e-10                                          # angiogenic
    np.savetxt(os.path.join(directory, "Brain_Model_Initial_Nodal_Field.dat"), u0)
    structure = np.zeros((mesh.n_elems, 2))
    structure[:, 0] = 40.0 + 5.0 * rng.random(mesh.n_elems)   # HU
    np.savetxt(
        os.path.join(directory, "Brain_Model_Initial_Elemental_Field.dat"),
        structure,
    )

    deck = f"""#
directory = 'PIHNA_simulation'
input_GMSH      = 'Brain_Model.msh'
input_nodal     = 'Brain_Model_Initial_Nodal_Field.dat'
input_elemental = 'Brain_Model_Initial_Elemental_Field.dat'
output_GMSH     = 'Brain_Model~processed.msh'
output_PARAVIEW = 'Brain_Model'
#
time_step_number = {n_steps}
time_step = 0.1
output_step = 10
refinement_step = 10000
#
mesh/skip_renumber_nodes_and_elements = false
mesh/AMR/max_steps = 1
mesh/AMR/max_level = 3
mesh/AMR/refine_percentage  = 0.5
mesh/AMR/coarsen_percentage = 0.1
#
range/active_tumor/min = 500.0
range/necrotic/min = 500.0
range/vascularity/min = 7200.0
#
cells_min_capacity = 1.0
cells_max_capacity = 2.39e+5
cells_max_capacity/exponent = 3
cytokines_max_capacity = 1.0e-8
#
necrosis/c = 500.0
necrosis/h = 200.0
necrosis/v = 300.0
#
diffuse/c = 0
taxis/c = 0
diffuse/h = 0
taxis/h = 0
produce/c = -2.5
switch/c/to/h = 1.0
switch/h/to/c = 1.82
switch/h/to/n = 0.5
#
diffuse/v = 0.5
taxis/v = 0
produce/v = 10.0
#
secrete/a/from/c = 2.77e-13
secrete/a/from/h = 5.22e-10
uptake/a/from/v = 0.
decay/a = 5678.4
#
"""
    with open(os.path.join(directory, "input.dat"), "w") as f:
        f.write(deck)
    _write_makefile(directory, "-m pihna")
    return directory


def make_adpm_case(directory: str, n: int = 28, seed: int = 1,
                   n_steps: int = 400) -> str:
    """Synthetic ADPM Alzheimer's case (deck values = run/HCP102513/input.dat;
    the real case is 25,935 nodes / 125,702 elements) on
    box_tet_mesh(n, n, n) with brain bounds and two parcellations."""
    os.makedirs(directory, exist_ok=True)
    mesh = _brain_mesh(n)
    mid = mesh.coords[mesh.connectivity].mean(axis=1)
    mesh.subdomain_id[:] = np.where(mid[:, 0] < 75.0, 10, 20)
    gmsh.write(mesh, os.path.join(directory, "Brain_Model.msh"))

    rng = np.random.default_rng(seed)
    r2 = ((mesh.coords - np.array([75.0, 60.0, 75.0])) ** 2).sum(axis=1)
    u0 = np.stack(
        [
            np.ones(mesh.n_nodes),                      # PrP
            0.3 * np.exp(-r2 / (2 * 15.0**2)),          # A_b seed
            0.05 * np.exp(-r2 / (2 * 10.0**2)),         # Tau seed
        ],
        axis=1,
    )
    np.savetxt(os.path.join(directory, "Brain_Model_Initial_Nodal_Field.dat"), u0)
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    np.savetxt(
        os.path.join(directory, "Brain_Model_Initial_Elemental_Field~symm.dat"),
        tracts,
    )

    deck = f"""#
input_GMSH      = 'Brain_Model.msh'
input_nodal     = 'Brain_Model_Initial_Nodal_Field.dat'
input_elemental = 'Brain_Model_Initial_Elemental_Field~symm.dat'
output_GMSH     = 'Brain_Model~processed.msh'
output_PARAVIEW = 'Brain_Model'
#
time_step_number = {n_steps}
time_step = 0.05
output_step = 20
#
decay/PrP = 1.000000e-4
decay/PrP/pulse/0 = 0.01
decay/PrP/pulse/1 = 10.0
#
taxis_1/A_b = 0.999999e+3
taxis_1/A_b/pulse/0 = -1
taxis_1/A_b/pulse/1 = 0.01
#
taxis_1/Tau = 0.999999e+3
taxis_1/Tau/pulse/0 = -1
taxis_1/Tau/pulse/1 = 0.01
decay/Tau = 1.000000e+1
decay/Tau/pulse/0 = 0.0005
#
"""
    with open(os.path.join(directory, "input.dat"), "w") as f:
        f.write(deck)
    _write_makefile(directory, "-m adpm")
    return directory
