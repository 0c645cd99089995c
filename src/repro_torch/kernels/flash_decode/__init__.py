"""Flash-decode (paged and contiguous) and chunked prefill: the CUDA
kernels' wrappers and their plain versions."""

from repro_torch.kernels.flash_decode.kernel import (flash_decode_paged,
                                                     flash_prefill_paged)

__all__ = ["flash_decode_paged", "flash_prefill_paged"]
