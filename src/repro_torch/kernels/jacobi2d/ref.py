"""Oracle, plain version and analytic terms of the Jacobi2D stencil, across
from :mod:`repro.kernels.jacobi2d.ref`."""

from __future__ import annotations

import torch


def jacobi_ref(u):
    """One sweep, Dirichlet boundary (edges pass through), in u's dtype."""
    avg = 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:])
    out = u.clone()
    out[1:-1, 1:-1] = avg.to(u.dtype)
    return out


def jacobi_plain(u: torch.Tensor) -> torch.Tensor:
    """The kernel body: the oracle's sweep in fp32, ((n + s) + w) + e then
    times 0.25, rounded once to u's dtype."""
    f = u.float()
    out = f.clone()
    out[1:-1, 1:-1] = 0.25 * (f[:-2, 1:-1] + f[2:, 1:-1] + f[1:-1, :-2]
                              + f[1:-1, 2:])
    return out.to(u.dtype)


def flops_bytes(H: int, W: int, dtype_bytes: int = 4) -> dict:
    """Per sweep: 4 flops/point; traffic = read u + write out (cold)."""
    n = float(H * W)
    flops = 4.0 * n
    bytes_ = 2.0 * n * dtype_bytes + n * dtype_bytes  # 5-pt reads ~cached: 3N words
    return {"flops": flops, "bytes": bytes_, "ai": flops / bytes_}


def work_terms(u: torch.Tensor) -> dict:
    """What one sweep must do at least: read u once and write out once (2N
    words; :func:`flops_bytes` keeps the reference's 3N) and 4 flops per
    interior point."""
    H, W = u.shape
    interior = max(H - 2, 0) * max(W - 2, 0)
    return {"flops": 4.0 * interior,
            "bytes": 2.0 * u.numel() * u.element_size()}
