"""SpMV kernel call surface (served by the kernel registry) + the
issue-count model, across from :mod:`repro.kernels.spmv.ops`.

``issue_counts`` is the INST_RETIRED analogue: how many vector issues each
variant needs.  Predicated (SVE/VLA-style) SpMV issues ceil(nnz/lane) per
row; fixed-width issues ceil(width/lane) always — their ratio is the
paper's Fig. 3a SpMV result (1.99x vs 1.0x).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.kernels.registry import (
    SPMV as spmv,
    SPMV_FIXED as spmv_padded,
)

__all__ = ["spmv", "spmv_padded", "issue_counts", "flops_bytes"]


def _numpy(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def issue_counts(row_nnz, width: int, lane: int = 128) -> dict:
    """Vector-issue counts (INST_RETIRED analogue) for the two variants."""
    nnz = _numpy(row_nnz)
    predicated = int(np.ceil(np.maximum(nnz, 1) / lane).sum())
    fixed = int(nnz.size * math.ceil(width / lane))
    scalar = int(np.maximum(nnz, 1).sum())  # 1 element / instruction
    return {
        "scalar": scalar,
        "predicated": predicated,
        "fixed_width": fixed,
        "r_ins_predicated": scalar / predicated,
        "r_ins_fixed": scalar / fixed,
    }


def flops_bytes(row_nnz, repeat: int = 1, dtype_bytes: int = 4) -> dict:
    """Analytic roofline terms for the synthetic benchmark (paper Sec. 3.2):
    per nonzero: 2*repeat FLOPs; traffic: val + colidx + gathered x."""
    nnz = float(_numpy(row_nnz).sum())
    return {
        "flops": 2.0 * repeat * nnz,
        "bytes": nnz * (dtype_bytes + 4 + dtype_bytes),
        "gather_bytes": nnz * dtype_bytes,
        "ai": 2.0 * repeat * nnz / (nnz * (dtype_bytes + 4 + dtype_bytes)),
    }
