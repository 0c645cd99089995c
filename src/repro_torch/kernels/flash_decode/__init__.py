"""Flash-decode (paged and contiguous) and chunked prefill: the CUDA
kernels' wrappers and their plain versions."""

from repro_torch.kernels.flash_decode.kernel import (
    commit_paged, flash_decode, flash_decode_paged,
    flash_decode_paged_sharded, flash_prefill_paged)

__all__ = ["commit_paged", "flash_decode", "flash_decode_paged",
           "flash_decode_paged_sharded", "flash_prefill_paged"]
