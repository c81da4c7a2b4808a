"""Device selection for code paths that must run on the GPU."""

from __future__ import annotations

import torch


def cuda_device(index: int = 0) -> torch.device:
    """torch.device("cuda", index), or RuntimeError when no CUDA device is
    present.  Never falls back to the CPU: a measurement or a kernel run
    that finds no card must fail, not run somewhere else."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {index}: "
                           f"{torch.cuda.device_count()} present")
    return torch.device("cuda", index)
