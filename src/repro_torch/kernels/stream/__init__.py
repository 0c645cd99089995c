"""STREAM copy/scale/add/triad: the CUDA kernel's wrappers and plain
versions."""
