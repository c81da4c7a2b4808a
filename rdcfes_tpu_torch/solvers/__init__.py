"""Krylov solvers, the block-Jacobi preconditioner and the solid's
Newton."""

from .krylov import (SolveResult, apply_block_jacobi, bicgstab,
                     block_jacobi_inverse, cg, gmres, solve_bcsr)
from .newton import NewtonOptions, newton_solve

__all__ = [
    "SolveResult",
    "block_jacobi_inverse",
    "apply_block_jacobi",
    "bicgstab",
    "cg",
    "gmres",
    "solve_bcsr",
    "NewtonOptions",
    "newton_solve",
]
