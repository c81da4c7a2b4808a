"""Results directory and input copies (copy of rdcfes_tpu.io.provenance).

As every driver of the C++ reference does (src/pihna.C:104-129): the
results directory is the deck's `directory` (default: a %Y%m%d_%H%M%S
timestamp), and the deck and the initial-condition files are copied
into it.  The solid and coupled drivers remove an existing directory
first (`wipe=True`, src/solid.C:124-135).
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Iterable, Optional


def timestamp_dirname() -> str:
    return time.strftime("%Y%m%d_%H%M%S")


def prepare_results_dir(
    directory: Optional[str],
    deck_path: Optional[str] = None,
    copies: Iterable[str] = (),
    wipe: bool = False,
) -> str:
    d = directory or timestamp_dirname()
    if wipe and os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d, exist_ok=True)
    for src in ([deck_path] if deck_path else []) + list(copies):
        if src and os.path.isfile(src):
            shutil.copy(src, os.path.join(d, os.path.basename(src)))
    return d
