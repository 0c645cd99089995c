"""Paged flash-decode: the CUDA kernel's wrapper and its plain version."""

from repro_torch.kernels.flash_decode.kernel import flash_decode_paged

__all__ = ["flash_decode_paged"]
