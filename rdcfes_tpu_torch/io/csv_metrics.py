"""Science-metric CSV writers of the PIHNA, ADPM and RIPF drivers (the
rows of rdcfes_tpu.io.csv_metrics, byte for byte).

Each replicates the C++ reference's `save_solution` (src/pihna.C:842-976,
src/adpm.C:690-829, src/ripf.C:777-864) as NumPy reductions over (E, K)
corner gathers of a host array u (N, V); on a MixedMesh, block by block,
the masks concatenated in block order as element_volumes is.
"""

from __future__ import annotations

from typing import Dict, Sequence, TextIO

import numpy as np

from ..mesh.core import Mesh, element_blocks


def _elem_mask(mesh, u_cols, cond) -> np.ndarray:
    """General per-element corner mask: `cond` maps one (E, K) corner
    gather per column of `u_cols` to an (E,) bool, per block."""
    return np.concatenate([cond(*[c[conn] for c in u_cols])
                           for _, conn in element_blocks(mesh)])


def _elem_in_range(mesh, u_col: np.ndarray, lo: float,
                   hi: float) -> np.ndarray:
    """(E,) bool: every corner of the element in [lo, hi] (the inclusion
    rule of src/pihna.C:903-959)."""
    return _elem_mask(mesh, (u_col,), lambda v: np.all(
        (v >= lo) & (v <= hi), axis=1))


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


def ripf_row(csv: TextIO, mesh: Mesh, u: np.ndarray, time: float,
             params: Dict[str, float]) -> None:
    """Tumour and fibrosis volumes: the elements whose every corner has HU
    in the deck's range_cc (range_fb) HU window and cc (fb) at least its
    minimum.  No header: the reference comments it out
    (src/ripf.C:800-807)."""
    vols = mesh.element_volumes()
    tum = _elem_mask(mesh, (u[:, 0], u[:, 1]), lambda HU_e, cc_e: np.all(
        (HU_e >= params["range_cc_HU_min"])
        & (HU_e <= params["range_cc_HU_max"])
        & (cc_e >= params["range_cc_min"]), axis=1))
    fib = _elem_mask(mesh, (u[:, 0], u[:, 2]), lambda HU_e, fb_e: np.all(
        (HU_e >= params["range_fb_HU_min"])
        & (HU_e <= params["range_fb_HU_max"])
        & (fb_e >= params["range_fb_min"]), axis=1))
    csv.write(f"{time:g},{vols[tum].sum():g},{vols[fib].sum():g}\n")
    csv.flush()
