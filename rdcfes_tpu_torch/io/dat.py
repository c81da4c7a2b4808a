"""Initial-condition `.dat` readers (copy of rdcfes_tpu.io.dat).

The C++ reference streams whitespace-separated floats in mesh order
(src/pihna.C:287-310 nodal, :251-264 elemental; src/adpm.C:241-261
tracts): the file's row order is the node/element numbering contract.
PROTEAS reads a line-based variant that skips blank lines and `#`
comments and fails on a malformed row (src/proteas.C:237-263):
`read_rows_tolerant`.
"""

from __future__ import annotations

import numpy as np


def read_stream(path: str, n_rows: int, n_cols: int) -> np.ndarray:
    """Plain whitespace-float stream, reshaped (n_rows, n_cols).

    Matches `fin >> a >> b >> ...` semantics: layout in the file is
    irrelevant, only token order counts."""
    with open(path) as f:
        data = np.array(f.read().split(), dtype=np.float64)
    need = n_rows * n_cols
    if data.size < need:
        raise ValueError(
            f"{path}: expected {need} values ({n_rows} rows x {n_cols}), "
            f"got {data.size}"
        )
    return data[:need].reshape(n_rows, n_cols)


def read_rows_tolerant(path: str, n_rows: int, n_cols: int) -> np.ndarray:
    """Line-based reader skipping blanks/comments; errors on malformed rows
    (PROTEAS semantics, src/proteas.C:241-253)."""
    out = np.empty((n_rows, n_cols))
    row = 0
    with open(path) as f:
        for line in f:
            if row >= n_rows:
                break
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            vals = s.split()
            if len(vals) < n_cols:
                raise ValueError(f"{path}: failed to read line: {line!r}")
            try:
                out[row] = [float(v) for v in vals[:n_cols]]
            except ValueError:
                raise ValueError(f"{path}: failed to read line: {line!r}")
            row += 1
    if row < n_rows:
        raise ValueError(f"{path}: only {row} of {n_rows} rows present")
    return out
