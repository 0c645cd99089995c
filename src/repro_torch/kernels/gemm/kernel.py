"""GEMM: the wrapper of the CUDA kernel in ``csrc/gemm.cu``, across from
:mod:`repro.kernels.gemm.kernel`.

:func:`gemm` checks the tile keywords as the reference does (each is
clamped to its dimension and must divide it), then takes CPU tensors to the
plain version in ``ref.py`` and launches the kernel for CUDA tensors; there
is no fallback from one to the other.  ``bm/bn/bk`` are the TPU kernel's
tiles; the CUDA kernel's tile (128 x 128, K slices of 8) is its own.
:func:`gemm_plain` runs the plain version on any device, with the same
checks.  ``gemm.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(x, y, bm: int, bn: int, bk: int) -> int:
    """Checks; returns the clamped bk."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm needs (M, K) @ (K, N), got {tuple(x.shape)} "
                         f"@ {tuple(y.shape)}")
    M, K = x.shape
    N = y.shape[1]
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if min(bm, bn, bk) <= 0 or M % bm or N % bn or K % bk:
        raise ValueError(f"({M},{N},{K}) not divisible by tile "
                         f"({bm},{bn},{bk})")
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise TypeError(f"gemm inputs must both be float32 or bfloat16, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"gemm inputs on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gemm inputs must be contiguous")
    return bk


def gemm(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128, bn: int = 128,
         bk: int = 128) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in x's dtype, fp32 accumulation."""
    bk = _check(x, y, bm, bn, bk)
    if x.device.type == "cpu":
        return ref.gemm_plain(x, y, bk)
    build.require_cuda("gemm", (x, y))
    M, K = x.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = build.function("gemm", "gemm_launch", _ARGTYPES)(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
        _DTYPE_CODE[x.dtype], build.stream_of(x))
    build.raise_on("gemm", err)
    gemm.launches += 1
    return out


gemm.launches = 0


def gemm_plain(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
               bn: int = 128, bk: int = 128) -> torch.Tensor:
    return ref.gemm_plain(x, y, _check(x, y, bm, bn, bk))
