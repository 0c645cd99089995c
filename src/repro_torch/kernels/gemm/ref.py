"""Oracle, plain version and analytic terms of the GEMM kernel, across from
:mod:`repro.kernels.gemm.ref`.  TF32 must be off for fp32 products on the
card (``repro_torch.core.device.resolve_device`` turns it off)."""

from __future__ import annotations

import torch


def gemm_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One fp32 product, cast to x's dtype."""
    return torch.matmul(x.float(), y.float()).to(x.dtype)


def gemm_plain(x: torch.Tensor, y: torch.Tensor, bk: int) -> torch.Tensor:
    """The kernel body: an fp32 accumulator over K in slices of ``bk``, one
    flush cast to x's dtype, as the TPU kernel walks K."""
    M, K = x.shape
    acc = torch.zeros((M, y.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, K, bk):
        acc.addmm_(x[:, k0:k0 + bk].float(), y[k0:k0 + bk].float())
    return acc.to(x.dtype)


def flops_bytes(M: int, N: int, K: int, dtype_bytes: int = 4) -> dict:
    """Analytic kernel cost: 2MNK FLOPs; cold traffic A+B+C."""
    flops = 2.0 * M * N * K
    bytes_ = (M * K + K * N + M * N) * dtype_bytes
    return {"flops": flops, "bytes": bytes_, "ai": flops / bytes_}


def work_terms(x: torch.Tensor, y: torch.Tensor) -> dict:
    """What one product must do at least: 2MNK flops; read x and y once,
    write the output once."""
    (M, K), N = x.shape, y.shape[1]
    return flops_bytes(M, N, K, x.element_size())
