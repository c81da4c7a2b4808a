"""Small scalar helpers (surface parity with src/utils.h:69-98, 231-244
of the reference app): the pow2..pow9 family, angle conversions, bound
clamps, sign, and the random-sampling helpers, on tensors or Python
numbers.  uniform_rand / normal_rand are defined but used by no driver of
the reference app; they draw from an explicit torch.Generator (the
reference takes a JAX key: the two streams differ).
"""

from __future__ import annotations

import math

import torch


def pow2(v): return v * v
def pow3(v): return v * pow2(v)
def pow4(v): return pow2(pow2(v))
def pow5(v): return v * pow4(v)
def pow6(v): return pow2(pow3(v))
def pow7(v): return v * pow6(v)
def pow8(v): return pow2(pow4(v))
def pow9(v): return pow3(pow3(v))


def degrees_to_radians(d):
    return d * (math.pi / 180.0)


def radians_to_degrees(r):
    return r * (180.0 / math.pi)


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


def uniform_rand(generator: torch.Generator, from_, to, shape=()
                 ) -> torch.Tensor:
    """f64 samples uniform on [from_, to) on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    return from_ + (to - from_) * u


def normal_rand(generator: torch.Generator, mean, stdev, shape=()
                ) -> torch.Tensor:
    """f64 samples of N(mean, stdev^2) on the generator's device."""
    return mean + stdev * torch.randn(shape, generator=generator,
                                      dtype=torch.float64,
                                      device=generator.device)
