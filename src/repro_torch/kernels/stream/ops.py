"""STREAM kernel call surface (served by the kernel registry) + the paper's
ELEN instruction model, across from :mod:`repro.kernels.stream.ops`.

``copy``/``scale``/``add``/``triad`` are :class:`~repro_torch.kernels.
registry.KernelOps` objects: call directly to run the kernel on CUDA
tensors (the plain version on CPU tensors), ``.kernel(...)`` for the CUDA
kernel alone, ``.interpret(...)`` for the plain version, ``.ref(...)`` for
the oracle.
"""

from __future__ import annotations

import math

from repro_torch.kernels.registry import (
    STREAM_ADD as add,
    STREAM_COPY as copy,
    STREAM_SCALE as scale,
    STREAM_TRIAD as triad,
)

__all__ = ["copy", "scale", "add", "triad", "issue_counts"]


def issue_counts(n_elements: int, elen_bits: int, vlen_bits: int = 128) -> dict:
    """Paper Sec. 4.2: R_ins for STREAM tracks VB = VLEN/ELEN even though
    wall time is bandwidth-bound and flat."""
    lanes = vlen_bits // elen_bits
    return {
        "scalar": n_elements,
        "vector": math.ceil(n_elements / lanes),
        "r_ins": n_elements / math.ceil(n_elements / lanes),
        "vb": lanes,
    }
