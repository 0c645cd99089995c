"""Oracle, plain version and problem maker of block-ELL SpMV (+ the paper's
repeat-K synthetic), across from :mod:`repro.kernels.spmv.ref`."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def dense_from_blockell(values, col_idx, row_nnz, n_cols: int):
    """Reconstruct the dense matrix (host-side, tests only)."""
    nb, rb, width = values.shape
    n_rows = nb * rb
    a = np.zeros((n_rows, n_cols), dtype=np.float64)
    v = values.double().cpu().numpy()
    c = col_idx.cpu().numpy()
    nz = row_nnz.cpu().numpy()
    for b in range(nb):
        for r in range(rb):
            for j in range(int(nz[b, r])):
                a[b * rb + r, c[b, r, j]] += v[b, r, j]
    return a


def spmv_ref(values, col_idx, row_nnz, x, *, repeat: int = 1):
    """y[i] = sum_j val[i,j] * x[col[i,j]] over the first row_nnz[i] entries,
    in the values' dtype.

    ``repeat`` mimics the paper's synthetic benchmark: the FMA work is done
    ``repeat`` times (each contributing 1/repeat) — same result, repeat x
    the arithmetic intensity.
    """
    nb, rb, width = values.shape
    lane = torch.arange(width, device=values.device)[None, None, :]
    mask = lane < row_nnz[:, :, None]
    gathered = x[col_idx.long()] * values  # (nb, rb, width)
    contrib = torch.where(mask, gathered, torch.zeros((), dtype=values.dtype))
    y = torch.zeros((nb, rb), dtype=values.dtype, device=values.device)
    for _ in range(repeat):
        y = y + contrib.sum(dim=-1) / repeat
    return y.reshape(nb * rb)


def spmv_plain(values: torch.Tensor, col_idx: torch.Tensor,
               row_nnz: torch.Tensor, x: torch.Tensor, *, repeat: int = 1,
               predicated: bool = True) -> torch.Tensor:
    """The kernel body: fp32 products and row sums (lanes at or past
    ``row_nnz`` masked when ``predicated``), then ``repeat`` loop-carried
    additions of rowsum * inv with inv = 1/repeat rounded to the values'
    dtype, rounded once to that dtype."""
    nb, rb, width = values.shape
    inv = torch.tensor(1.0 / repeat, dtype=values.dtype).item()
    prod = values.float() * x.float()[col_idx.long()]
    if predicated:
        lane = torch.arange(width, device=values.device)
        prod = torch.where(lane < row_nnz[..., None], prod, 0.0)
    rowsum = prod.sum(dim=-1)
    acc = torch.zeros_like(rowsum)
    for _ in range(repeat):
        acc = acc + rowsum * inv
    return acc.to(values.dtype).reshape(nb * rb)


_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit ``c``,
    in halves of 16 bits so that no product leaves int64."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def probe_columns(rows: int, width: int, n_cols: int,
                  device="cpu") -> torch.Tensor:
    """(rows, width) int64: the gather probe's column of every element, a
    32-bit mix of its flat index ``r * width + j`` scaled onto [0, n_cols),
    as ``probe_col`` in ``csrc/spmv.cu`` computes it."""
    i = torch.arange(rows * width, dtype=torch.int64, device=device) & _U32
    h = _mul32(i, 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return ((h * n_cols) >> 32).reshape(rows, width)


def gather_probe_plain(row_nnz: torch.Tensor, x: torch.Tensor, width: int,
                       *, predicated: bool = True) -> torch.Tensor:
    """The gather probe's function: each row's sum, in fp32, of x at
    :func:`probe_columns` over its first ``row_nnz`` lanes (clamped to [0,
    width]) or, not ``predicated``, over all ``width`` lanes."""
    rows = row_nnz.numel()
    g = x.float()[probe_columns(rows, width, x.numel(), x.device)]
    if predicated:
        lane = torch.arange(width, device=x.device)
        g = torch.where(lane < row_nnz.reshape(rows, 1), g, 0.0)
    return g.sum(dim=-1)


def make_problem(n_rows: int, n_cols: int, *, row_block: int = 8,
                 max_nnz: int = 64, width_pad: int = 128,
                 dtype: torch.dtype = torch.float32, zipf_a: float = 1.3,
                 generator: Optional[torch.Generator] = None,
                 device="cpu"):
    """Random ragged sparse matrix in block-ELL layout (Zipf row lengths —
    the irregularity that defeats fixed-width SIMD in the paper), drawn
    from ``generator`` on ``device``: (values, col_idx int32, row_nnz
    int32).  The same law as the reference's, not its bits."""
    nb = -(-n_rows // row_block)
    width = -(-max_nnz // width_pad) * width_pad
    kw = dict(generator=generator, device=device)
    u = torch.rand((nb, row_block), **kw)
    row_nnz = (1 + (max_nnz - 1) * u ** zipf_a).to(torch.int32)
    col_idx = torch.randint(0, n_cols, (nb, row_block, width),
                            dtype=torch.int32, **kw)
    values = torch.randn((nb, row_block, width), **kw).to(dtype)
    lane = torch.arange(width, device=device)
    values = torch.where(lane < row_nnz[..., None], values,
                         torch.zeros((), dtype=dtype))
    return values, col_idx, row_nnz


def work_terms(values: torch.Tensor, row_nnz: torch.Tensor, x: torch.Tensor,
               *, repeat: int = 1, predicated: bool = True) -> dict:
    """What one product must do at least, from these inputs: read the live
    values and column indices (predicated: the first ``row_nnz`` lanes of a
    row; fixed width: every lane), ``row_nnz`` (predicated), x once, write
    y once; 2 * repeat flops per live entry."""
    nb, rb, width = values.shape
    live = float(row_nnz.clamp(0, width).sum())
    read = live if predicated else float(values.numel())
    itemsize = values.element_size()
    bytes_ = (read * (itemsize + 4) + x.numel() * x.element_size()
              + nb * rb * itemsize
              + (row_nnz.numel() * 4 if predicated else 0))
    return {"flops": 2.0 * repeat * live, "bytes": bytes_}
