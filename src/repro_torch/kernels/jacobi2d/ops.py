"""Jacobi2D kernel call surface (served by the kernel registry) + the
multi-sweep driver, across from :mod:`repro.kernels.jacobi2d.ops`."""

from __future__ import annotations

from repro_torch.kernels.registry import JACOBI_STEP as jacobi_step

__all__ = ["jacobi_step", "jacobi"]


def jacobi(u, *, sweeps: int = 10, block_rows: int = 128):
    """``sweeps`` Jacobi sweeps, one kernel launch each on the card."""
    for _ in range(sweeps):
        u = jacobi_step(u, block_rows=block_rows)
    return u
