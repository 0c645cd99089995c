"""GEMM: the CUDA kernel's wrapper and plain version."""
