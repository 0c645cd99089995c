"""GEMM kernel call surface (served by the kernel registry), across from
:mod:`repro.kernels.gemm.ops`.

The reference's VMEM tile model (``vmem_bytes``, ``pick_tiles``) becomes
the card's: :func:`smem_bytes` is a launch variant's shared memory a block,
from ``gemm_plan``, and :func:`pick_tiles` the port's projection of its
GEMM tuning space (:func:`repro_torch.tuning.spaces.pick_gemm_tiles`): the
largest-volume compiled variant of the planned route that fits the budget
and the shape."""

from __future__ import annotations

from typing import Any, Tuple

from repro_torch.kernels.gemm import kernel
from repro_torch.kernels.registry import GEMM as gemm
from repro_torch.tuning.space import SMEM_LIMIT
from repro_torch.tuning.spaces import pick_gemm_tiles


def smem_bytes(M: int, N: int, K: int, dtype: Any, tile_m=None, tile_n=None,
               tile_k=None, stages=None) -> int:
    """Shared memory a block of the (M, K) @ (K, N) product in ``dtype``
    takes in the named launch variant (the route's default by default)."""
    return kernel.gemm_plan(M, N, K, dtype, True, tile_m, tile_n, tile_k,
                            stages).smem


def pick_tiles(M: int, N: int, K: int, dtype: Any, *,
               smem_budget: int = SMEM_LIMIT) -> Tuple[int, int, int, int]:
    """(tile_m, tile_n, tile_k, stages): see
    :func:`repro_torch.tuning.spaces.pick_gemm_tiles`."""
    return pick_gemm_tiles(M, N, K, dtype, smem_budget=smem_budget)


__all__ = ["gemm", "pick_tiles", "smem_bytes"]
