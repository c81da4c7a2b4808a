"""Science-metric CSV writers of the PIHNA and ADPM drivers (the rows of
rdcfes_tpu.io.csv_metrics, byte for byte).

Each replicates the C++ reference's `save_solution` (src/pihna.C:842-976,
src/adpm.C:690-829) as NumPy reductions over (E, K) corner gathers of a
host array u (N, V).  RIPF's rows come with its driver (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

from typing import Dict, Sequence, TextIO

import numpy as np

from ..mesh.core import Mesh


def _elem_in_range(mesh: Mesh, u_col: np.ndarray, lo: float,
                   hi: float) -> np.ndarray:
    """(E,) bool: every corner of the element in [lo, hi] (the inclusion
    rule of src/pihna.C:903-959)."""
    vals_e = u_col[mesh.connectivity]
    return np.all((vals_e >= lo) & (vals_e <= hi), axis=1)


def pihna_header(csv: TextIO) -> None:
    csv.write(
        '"TIME","DEGREES_OF_FREEDOM","ACTIVE_TUMOR_VOLUME","NECROTIC_VOLUME",'
        '"VASCULARITY_VOLUME","TOTAL_CELL_VOLUME"\n'
    )


def pihna_row(csv: TextIO, mesh: Mesh, u: np.ndarray, time: float,
              params: Dict[str, float]) -> None:
    """Volumes of the active-tumour, necrotic, vascular and total-cell
    regions; `params` holds cells_max_capacity and the deck's range_*."""
    vols = mesh.element_volumes()
    Kk = params["cells_max_capacity"]

    active = _elem_in_range(
        mesh, u[:, 1] + u[:, 2],
        params["range_active_tumor_min"], params["range_active_tumor_max"])
    necrotic = _elem_in_range(
        mesh, u[:, 0], params["range_necrotic_min"], params["range_necrotic_max"])
    vascular = _elem_in_range(
        mesh, u[:, 3],
        params["range_vascularity_min"], params["range_vascularity_max"])
    total = _elem_in_range(
        mesh, (u[:, 0] + u[:, 1] + u[:, 2] + u[:, 3]) / Kk,
        params["range_total_cell_min"], params["range_total_cell_max"])

    dof = 5 * mesh.n_nodes
    csv.write(
        f"{time:g},{dof},{vols[active].sum():g},{vols[necrotic].sum():g},"
        f"{vols[vascular].sum():g},{vols[total].sum():g}\n"
    )
    csv.flush()


def adpm_header(csv: TextIO, parcellation: Sequence[int]) -> None:
    cols = ['"TIME"']
    for pid in parcellation:
        cols.append(f'"CONCENTRATION__A_b__{pid}"')
        cols.append(f'"CONCENTRATION__Tau__{pid}"')
    for pid in parcellation:
        cols.append(f'"VOLUME__A_b__{pid}"')
        cols.append(f'"VOLUME__Tau__{pid}"')
    csv.write(",".join(cols) + "\n")


def adpm_row(csv: TextIO, mesh: Mesh, u: np.ndarray, time: float,
             params: Dict[str, float], elem_avg: np.ndarray) -> None:
    """elem_avg: (E, 2) JxW-integrated (A_b, Tau) per element.

    The reference's quirk is kept: a parcellation's "concentration" is
    ASSIGNED element by element, so its last element (highest id) wins
    (src/adpm.C:780-784 uses `=`, not `+=`)."""
    vols = mesh.element_volumes()
    subdomain = np.asarray(mesh.subdomain_id)
    parcellation = sorted(int(s) for s in np.unique(subdomain))

    conc = {}
    for pid in parcellation:
        last = np.nonzero(subdomain == pid)[0][-1]
        conc[pid] = (elem_avg[last, 0] / vols[last],
                     elem_avg[last, 1] / vols[last])

    ab_ok = _elem_in_range(mesh, u[:, 1],
                           params["range_A_b_min"], params["range_A_b_max"])
    ta_ok = _elem_in_range(mesh, u[:, 2],
                           params["range_Tau_min"], params["range_Tau_max"])

    row = [f"{time:g}"]
    for pid in parcellation:
        row += [f"{conc[pid][0]:g}", f"{conc[pid][1]:g}"]
    for pid in parcellation:
        sel = subdomain == pid
        row += [f"{vols[sel & ab_ok].sum():g}", f"{vols[sel & ta_ok].sum():g}"]
    csv.write(",".join(row) + "\n")
    csv.flush()
