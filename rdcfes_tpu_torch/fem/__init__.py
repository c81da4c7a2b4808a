"""Finite-element layer: TET4 tables, geometry, weak form and the CUDA
kernels of the qp path."""
