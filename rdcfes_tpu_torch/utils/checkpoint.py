"""Checkpoint / resume of a driver's state (the layout of
rdcfes_tpu.utils.checkpoint, so a checkpoint written by either package
resumes in the other).

One compressed `.npz` holds the state arrays (transient: u, u_old,
u_older, u_raw, each (N, V); solid: x (N, 3)), any extra arrays, and
`__step`, `__time`, `__params_hash` (sha256 of the deck parameters,
canonicalised, first 16 hex digits) and `__state_keys`, the names that
route back into the state.  `load_checkpoint` refuses a checkpoint whose
parameter hash differs from the deck's, so a resumed run cannot go on
with other physics.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _params_hash(params: Dict) -> str:
    canon = json.dumps(
        {k: (float(v) if isinstance(v, (int, float, np.floating)) else str(v))
         for k, v in sorted(params.items())},
        sort_keys=True,
    )
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, state: Dict, step: int, time_value: float,
                    params: Optional[Dict] = None, **extra_arrays) -> None:
    """Write `state` (arrays or tensors), the step, the time, the hash of
    `params` and `extra_arrays` to `path`."""
    arrays = {k: _host(v) for k, v in state.items()}
    arrays.update({k: _host(v) for k, v in extra_arrays.items()})
    np.savez_compressed(
        path,
        __step=np.asarray(step),
        __time=np.asarray(time_value),
        __params_hash=np.asarray(_params_hash(params or {})),
        __state_keys=np.asarray(sorted(state.keys())),
        **arrays,
    )


def load_checkpoint(path: str, params: Optional[Dict] = None
                    ) -> Tuple[Dict, int, float, Dict]:
    """Returns (state, step, time, extra arrays), all NumPy; raises
    ValueError if the parameter hash does not match `params`."""
    with np.load(path) as z:
        stored_hash = str(z["__params_hash"])
        if params is not None and stored_hash != _params_hash(params):
            raise ValueError(
                f"{path}: checkpoint was written with different parameters "
                f"(hash {stored_hash} != {_params_hash(params)})"
            )
        step = int(z["__step"])
        time_value = float(z["__time"])
        if "__state_keys" in z.files:
            state_keys = {str(k) for k in z["__state_keys"]}
        else:  # checkpoints written before the manifest
            state_keys = {k for k in z.files if k.startswith("u")}
        state = {}
        extra = {}
        for k in z.files:
            if k.startswith("__"):
                continue
            (state if k in state_keys else extra)[k] = z[k]
    return state, step, time_value, extra
