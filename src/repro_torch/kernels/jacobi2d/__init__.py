"""Jacobi 2D 5-point sweep: the CUDA kernel's wrapper and plain version."""
