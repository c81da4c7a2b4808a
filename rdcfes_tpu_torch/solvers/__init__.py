"""Krylov solvers and preconditioners."""
