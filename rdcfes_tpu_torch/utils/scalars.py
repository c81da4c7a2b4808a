"""Small scalar helpers (surface parity with src/utils.h:69-98 of the
reference app): the pow2..pow9 family, bound clamps and sign, on tensors
or Python numbers."""

from __future__ import annotations

import torch


def pow2(v): return v * v
def pow3(v): return v * pow2(v)
def pow4(v): return pow2(pow2(v))
def pow5(v): return v * pow4(v)
def pow6(v): return pow2(pow3(v))
def pow7(v): return v * pow6(v)
def pow8(v): return pow2(pow4(v))
def pow9(v): return pow3(pow3(v))


def apply_lbound(L, X: torch.Tensor) -> torch.Tensor:
    return torch.clamp(X, min=L)


def apply_ubound(X: torch.Tensor, U) -> torch.Tensor:
    return torch.clamp(X, max=U)


def apply_bounds(L, X: torch.Tensor, U) -> torch.Tensor:
    return torch.clamp(X, L, U)


def sign(r: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    """+1 / -1 / 0 with a dead zone (src/utils.h:92-98)."""
    one = torch.ones_like(r, dtype=torch.int64)
    return torch.where(r > tol, one, torch.where(r < -tol, -one, 0 * one))
