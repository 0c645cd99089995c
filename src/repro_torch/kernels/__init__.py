"""Hand-written Hopper kernels of the port, one package per TPU kernel
family of :mod:`repro.kernels`."""
