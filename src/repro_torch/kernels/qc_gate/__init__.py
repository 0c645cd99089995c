"""The quantum-circuit RX gate: the CUDA kernel's wrapper and plain
version."""
