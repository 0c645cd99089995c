"""Flash-decode kernel call surface (served by the kernel registry), across
from :mod:`repro.kernels.flash_decode.ops`.

``flash_decode`` (the contiguous-cache decode) and ``flash_prefill`` (the
chunked prefill with the reference's argument list) are
:class:`~repro_torch.kernels.registry.KernelOps` objects: call directly to
run the CUDA kernel on CUDA tensors (the plain version on CPU tensors),
``.kernel(...)`` for the CUDA kernel alone, ``.interpret(...)`` for the
plain version, ``.ref(...)`` for the oracle.  The paged wrappers the
serving path calls, the tensor-parallel ``flash_decode_paged_sharded``
among them, are exported from the kernel module as they are.
"""

from __future__ import annotations

from repro_torch.kernels.flash_decode.kernel import (
    commit_paged, flash_decode_paged, flash_decode_paged_sharded,
    flash_prefill_paged)
from repro_torch.kernels.registry import FLASH_DECODE as flash_decode
from repro_torch.kernels.registry import FLASH_PREFILL as flash_prefill

__all__ = [
    "commit_paged",
    "flash_decode",
    "flash_decode_paged",
    "flash_decode_paged_sharded",
    "flash_prefill",
    "flash_prefill_paged",
]
