"""Oracle, plain version and analytic terms of the STREAM kernels
(McCalpin semantics), across from :mod:`repro.kernels.stream.ref`.

The oracles compute in the arrays' dtype, as the reference's do.  The plain
version is the kernel body in PyTorch: 16-bit values widened to fp32, each
op's result rounded to the arrays' dtype (the triad's q*b, then its sum),
q already rounded to that dtype (as JAX's weak typing rounds a Python
float); it equals the oracle bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

#: words moved and flops per element (McCalpin counting)
WORDS = {"copy": 2, "scale": 2, "add": 3, "triad": 3}
FLOPS = {"copy": 0, "scale": 1, "add": 1, "triad": 2}


def copy_ref(a):
    return a.clone()


def scale_ref(a, q):
    return a * torch.tensor(q, dtype=a.dtype)


def add_ref(a, b):
    return a + b


def triad_ref(a, b, q):
    return a + torch.tensor(q, dtype=a.dtype) * b


def round_to(q: float, dtype: torch.dtype) -> float:
    """``q`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(q, dtype=dtype).item()


def stream_plain(op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                 q: float = 0.0) -> torch.Tensor:
    """The kernel body: c = a, q*a, a + b or a + q*b in fp32, each op
    rounded to a's dtype (the triad's q*b, then the sum).  ``q`` must
    already be rounded to a's dtype (:func:`round_to`)."""
    if op == "copy":
        return a.clone()
    fa = a.float()
    if op == "scale":
        r = fa * q
    elif op == "add":
        r = fa + b.float()
    elif op == "triad":
        r = fa + (q * b.float()).to(a.dtype).float()
    else:
        raise ValueError(f"unknown STREAM op {op!r}")
    return r.to(a.dtype)


def flops_bytes(kind: str, n_elements: int, dtype_bytes: int) -> dict:
    """McCalpin counting: copy/scale move 2N words, add/triad 3N."""
    words = WORDS[kind]
    flops = FLOPS[kind] * n_elements
    bytes_ = words * n_elements * dtype_bytes
    return {"flops": float(flops), "bytes": float(bytes_),
            "ai": flops / bytes_ if bytes_ else 0.0}


def work_terms(op: str, a: torch.Tensor) -> dict:
    """What one call must do at least: read each input once and write c
    once (McCalpin's words), FLOPS[op] flops per element."""
    return flops_bytes(op, a.numel(), a.element_size())
