"""Block-ELL SpMV, predicated and fixed-width: the CUDA kernel's wrappers
and plain versions."""
