"""Synthetic PIHNA, ADPM, RIPF, PROTEAS and coupled HCC case directories
(the files of rdcfes_tpu.cases' make_*_case, byte for byte, except that
the Makefile launches rdcfes_tpu_torch.cli).

The patient meshes of the C++ reference's run/ cases are not in the
repository, so runs at patient scale need stand-ins: each function writes
a complete case directory (Gmsh mesh, nodal/elemental IC `.dat` files,
`input.dat` deck and a Makefile) at the documented case size.  The
signatures are the reference's, so a caller switches packages unchanged.
PIHNA, ADPM, RIPF and PROTEAS also take `mixed=True` (the box as HEX8 +
PYRAMID5 + TET4 blocks, mesh.generators.box_mixed_mesh) and `order=2`
(TET10, mesh.generators.tet4_to_tet10); HCC takes `mixed=True`.
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import box_mixed_mesh, box_tet_mesh, gmsh, tet4_to_tet10

_BRAIN = ((0, 150.0), (0, 180.0), (0, 150.0))
_LUNG = ((0, 250.0), (0, 180.0), (0, 250.0))
_CUBE = ((0, 100.0),) * 3


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


def _case_mesh(n: int, mixed: bool, order: int, bounds=_BRAIN):
    """The box over `bounds` as a MixedMesh (box_mixed_mesh(max(n, 3), n,
    n)), box_tet_mesh(n, n, n), or its TET10 upgrade."""
    if mixed:
        if order != 1:
            raise ValueError("mixed meshes are first-order")
        return box_mixed_mesh(max(n, 3), n, n, bounds=bounds)
    if order not in (1, 2):
        raise ValueError(f"order {order}: 1 or 2")
    mesh = box_tet_mesh(n, n, n, bounds=bounds)
    return tet4_to_tet10(mesh) if order == 2 else mesh


def make_pihna_case(directory: str, n: int = 28, seed: int = 0,
                    n_steps: int = 120, mixed: bool = False,
                    order: int = 1) -> str:
    """Synthetic PIHNA glioma case (deck values = run/PIHNA/input.dat) on
    box_tet_mesh(n, n, n) with brain bounds; mixed=True meshes the same
    box with HEX8 + PYRAMID5 + TET4 blocks (the stand-in for a patient
    mesh with transition elements), order=2 upgrades the tets to TET10."""
    mesh = _case_mesh(n, mixed, order)
    os.makedirs(directory, exist_ok=True)
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
                   n_steps: int = 400, mixed: bool = False,
                   order: int = 1) -> str:
    """Synthetic ADPM Alzheimer's case (deck values = run/HCP102513/input.dat;
    the real case is 25,935 nodes / 125,702 elements) on
    box_tet_mesh(n, n, n) with brain bounds and two parcellations;
    mixed=True and order=2 as make_pihna_case (the tracts then an
    elemental field over the blocks)."""
    mesh = _case_mesh(n, mixed, order if mixed else 1)
    # two parcellation regions, by element centroid
    for conn, sid in ([(b.connectivity, b.subdomain_id) for b in mesh.blocks]
                      if mixed else [(mesh.connectivity, mesh.subdomain_id)]):
        mid = mesh.coords[conn].mean(axis=1)
        sid[:] = np.where(mid[:, 0] < 75.0, 10, 20)
    if order == 2:
        mesh = tet4_to_tet10(mesh)
    os.makedirs(directory, exist_ok=True)
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


def make_ripf_case(directory: str, n: int = 16, seed: int = 2,
                   n_steps: int = 120, mixed: bool = False,
                   order: int = 1) -> str:
    """Synthetic RIPF lung-fibrosis case (deck values = run/RIPF133/input.dat;
    the real case is 15,700 nodes) on box_tet_mesh(n, n, n) over a
    250x180x250 mm box, with a broad and a focus RT dose; mixed=True and
    order=2 as make_pihna_case (mixed=True ignores `order`, as the
    reference does)."""
    mesh = _case_mesh(n, mixed, 1 if mixed else order, _LUNG)
    os.makedirs(directory, exist_ok=True)
    gmsh.write(mesh, os.path.join(directory, "Lung_Model.msh"))

    rng = np.random.default_rng(seed)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0 = np.stack(
        [
            -800.0 + 100.0 * rng.random(mesh.n_nodes),       # HU (aerated lung)
            0.4 * np.exp(-r2 / (2 * 20.0**2)),               # tumour
            0.05 * np.ones(mesh.n_nodes),                    # fibroblasts
        ],
        axis=1,
    )
    np.savetxt(os.path.join(directory, "Lung_Model_Initial_Nodal_Field.dat"), u0)
    rt = np.stack(
        [
            50.0 * np.exp(-r2 / (2 * 40.0**2)),              # broad beam
            16.0 * np.exp(-r2 / (2 * 25.0**2)),              # focus boost
        ],
        axis=1,
    )
    np.savetxt(
        os.path.join(directory, "Lung_Model_Initial_Nodal_Field~RT.dat"), rt
    )

    deck = f"""#
input_GMSH     = 'Lung_Model.msh'
input_nodal    = 'Lung_Model_Initial_Nodal_Field.dat'
input_nodal_RT = 'Lung_Model_Initial_Nodal_Field~RT.dat'
output_GMSH    = 'Lung_Model~processed.msh'
output_PARAVIEW= 'Lung_Model'
#
time_step_number = {n_steps}
time_step = 0.1
output_time_points = ' 10 30 60 90 120 '
#
RT_dose/broad/fractions=28
RT_dose/focus/fractions=8
volume_fraction/stroma    =0.30
volume_fraction/parenchyma=0.20
volume_fraction/exponent=2.5
volume_fraction/min_vacant=1.e-5
HU/min = -1000.
HU/max = +1000.
#
HU/phi/cc/build=0.
HU/phi/cc/decay=0.
HU/phi/fb/build=0.
HU/phi/fb/decay=0.
HU/phi/tolerance=1.0e-3
#
cc/delta=0.0864
cc/delta/RT/a=0.3
cc/delta/RT/b=0.03
#
fb/lambda= 0.01
fb/lambda/RT/r=1.0
fb/omega= 0.1
fb/diffusion =1.0e-20
fb/haptotaxis=0.05
#
"""
    with open(os.path.join(directory, "input.dat"), "w") as f:
        f.write(deck)
    _write_makefile(directory, "-m ripf")
    return directory


def make_proteas_case(directory: str, n: int = 12, seed: int = 3,
                      n_steps: int = 40, mixed: bool = False,
                      order: int = 1) -> str:
    """Synthetic PROTEAS radiotherapy-response case on box_tet_mesh(n, n,
    n) over a 100 mm cube.  No run/ deck ships for PROTEAS, so the deck
    follows the input() defaults and comment hints of proteas.C:93-216,
    with a brain-like hos/tum/nec/vsc/oed composition and an AUX file of
    HU and RT dose; mixed=True and order=2 as make_ripf_case."""
    mesh = _case_mesh(n, mixed, 1 if mixed else order, _CUBE)
    os.makedirs(directory, exist_ok=True)
    gmsh.write(mesh, os.path.join(directory, "Proteas_Model.msh"))

    rng = np.random.default_rng(seed)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    tum = 0.4 * np.exp(-r2 / (2 * 15.0**2))
    nec = 0.1 * np.exp(-r2 / (2 * 8.0**2))
    hos = np.clip(0.8 - tum - nec, 0.0, None)
    vsc = 0.12 * np.ones(mesh.n_nodes) - 0.05 * np.exp(-r2 / (2 * 10.0**2))
    oed = 0.02 * np.exp(-r2 / (2 * 20.0**2))
    u0 = np.stack([hos, tum, nec, vsc, oed], axis=1)
    np.savetxt(os.path.join(directory, "Proteas_Initial_Nodal_Field.dat"),
               u0, fmt="%.9g")
    # AUX: HU (CT density) + RTD (radiotherapy dose, Gy)
    hu = rng.uniform(20.0, 80.0, mesh.n_nodes)
    rtd = 60.0 * np.exp(-r2 / (2 * 20.0**2))
    np.savetxt(os.path.join(directory, "Proteas_Aux_Nodal_Field.dat"),
               np.stack([hu, rtd], axis=1), fmt="%.9g")

    deck = f"""#
directory = simulation
input_GMSH = Proteas_Model.msh
input_nodal = Proteas_Initial_Nodal_Field.dat
input_nodal_aux = Proteas_Aux_Nodal_Field.dat
output_Paraview = out
#
time_step = 0.01
time_step_number = {n_steps}
output_step = {max(1, n_steps // 4)}
#
cells/total_capacity = 2.0
radiotherapy/max_dosage = 60.0
host/proliferation = 0.4
host/vsc_threshold = 0.05
tumour/diffusion = 0.1
tumour/diffusion_host = 0.05
tumour/proliferation = 0.5
tumour/vsc_threshold = 0.05
necrosis/slope = 2.0
oedema/diffusion = 0.1
"""
    with open(os.path.join(directory, "input.dat"), "w") as f:
        f.write(deck)
    _write_makefile(directory, "-m proteas input=input.dat")
    return directory


def make_hcc_case(directory: str, n: int = 8, seed: int = 4,
                  n_steps: int = 40, n_loading: int = 4,
                  mixed: bool = False) -> str:
    """Synthetic coupled-HCC case (deck values = run/Coupled/HCC/input.dat,
    scaled down; the patient HCC_Model.msh is not in the repository) on
    box_tet_mesh(n, n, n) over a 10 mm cube, with three subdomains (3000
    host, 3001 capsule, 3002 growing tumour core: the material ids of the
    shipped deck) and the shipped boundary-condition table mapped onto
    the box: 2000 fixed at z = 0, 2002 and 2003 z-pinned on the two x
    faces.  `seed` is unused, as in the reference.  mixed=True meshes the
    box with HEX8 + PYRAMID5 + TET4 blocks, the subdomains set per
    block."""
    os.makedirs(directory, exist_ok=True)
    if mixed:
        mesh = box_mixed_mesh(max(n, 3), n, n, bounds=((0, 10.0),) * 3)
        parts = [(b.connectivity, b.subdomain_id) for b in mesh.blocks]
    else:
        mesh = box_tet_mesh(n, n, n, bounds=((0, 10.0),) * 3)
        parts = [(mesh.connectivity, mesh.subdomain_id)]
    for conn, sid in parts:
        centers = mesh.coords[conn].mean(axis=1)
        rc2 = ((centers - 5.0) ** 2).sum(axis=1)
        sid[:] = 3000
        sid[rc2 < 9.0] = 3001
        sid[rc2 < 4.0] = 3002
    bid, bf = mesh.boundary_id, mesh.boundary_faces
    valid = bf >= 0  # a MixedMesh pads its triangles with -1
    fc = (np.where(valid[..., None], mesh.coords[np.maximum(bf, 0)], 0.0)
          .sum(axis=1) / valid.sum(axis=1, keepdims=True))
    bid[:] = 0
    bid[np.isclose(fc[:, 2], 0.0)] = 2000
    bid[np.isclose(fc[:, 0], 0.0)] = 2002
    bid[np.isclose(fc[:, 0], 10.0)] = 2003
    gmsh.write(mesh, os.path.join(directory, "HCC_Model.msh"))

    r2 = ((mesh.coords - 5.0) ** 2).sum(axis=1)
    l = np.clip(0.6 - 0.4 * np.exp(-r2 / 4.0), 0.0, None)   # liver
    c = 0.4 * np.exp(-r2 / 4.0)                              # cancer
    nec = 0.05 * np.exp(-r2 / 2.0)                           # necrotic
    u0 = np.stack([l, c, nec], axis=1)
    np.savetxt(os.path.join(directory, "HCC_Initial_Nodal_Field.dat"),
               u0, fmt="%.9g")

    deck = f"""#
directory = simulation
input_GMSH = HCC_Model.msh
input_nodal = HCC_Initial_Nodal_Field.dat
output_PARAVIEW = out
#
time_step = 0.01
number_of_time_steps = {n_steps}
number_of_loading_steps = {n_loading}
output_step = {max(1, n_steps // 2)}
remeshing_step = 0
#
solver/quiet = false
solver/nonlinear/max_nonlinear_iterations = 30
solver/nonlinear/relative_step_tolerance = 1.e-3
solver/nonlinear/relative_residual_tolerance = 1.e-6
solver/nonlinear/absolute_residual_tolerance = 1.e-8
solver/nonlinear/require_reduction = false
solver/linear/max_linear_iterations = 50000
solver/linear/initial_linear_tolerance = 1.e-3
solver/use_symmetry = true
#
mesh/skip_renumber_nodes_and_elements = false
mesh/AMR/max_steps = 1
mesh/AMR/max_level = 2
mesh/AMR/refine_percentage  = 0.2
mesh/AMR/coarsen_percentage = 0.2
#
cells/min_capacity = 0.0
cells/max_capacity = 1.0
cells/max_capacity/exponent = 3
#
produce/c = 0.5
diffuse/c = 0.01
necrosis/c = 0.1
#
BCs = ' 2000 2002 2003 '
BC/2000/displacement/0 = +0.000
BC/2000/displacement/1 = +0.000
BC/2000/displacement/2 = +0.000
BC/2002/displacement/0 = NAN
BC/2002/displacement/1 = NAN
BC/2002/displacement/2 = +0.000
BC/2003/displacement/0 = NAN
BC/2003/displacement/1 = NAN
BC/2003/displacement/2 = +0.000
BCs/displacement_penalty = 1.e+8
#
materials = ' 3000 3001 3002 '
material/3000/Hyperelastic/Young   = 2.0e+3
material/3000/Hyperelastic/Poisson = 0.4
material/3001/Hyperelastic/Young   = 2.0e+3
material/3001/Hyperelastic/Poisson = 0.4
material/3002/Hyperelastic/Young   = 2.0e+3
material/3002/Hyperelastic/Poisson = 0.4
material/3002/Hyperelastic/VolumetricStretchRatio/rate_0 = 3.0e-1
material/3002/Hyperelastic/VolumetricStretchRatio/rate_1 = 3.0e-1
material/3002/Hyperelastic/VolumetricStretchRatio/rate_2 = 3.0e-1
"""
    with open(os.path.join(directory, "input.dat"), "w") as f:
        f.write(deck)
    _write_makefile(directory, "-c hcc")
    return directory
