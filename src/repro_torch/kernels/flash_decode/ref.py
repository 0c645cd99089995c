"""Plain PyTorch version of the paged flash-decode kernel, and its
analytic work terms.

:func:`flash_decode_paged_ref` ports ``decode_paged_ref`` of
``repro/kernels/flash_decode/ref.py``: gather each slot's logical view
through its block table, run a fp32 masked softmax, cast back.  The CPU
path and the tests use it; on the card it serves only as the yardstick the
kernel is compared with.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_decode_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           valid_len: torch.Tensor) -> torch.Tensor:
    """q (B,KV,G,D); k/v_pool (n_blocks, bs, KV, D); block_tables (B, nb)
    int32; valid_len (B,) int32 with every slot >= 1 -> (B,KV,G,D) in q's
    dtype."""
    B, KV, G, D = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    idx = block_tables.long()
    k = k_pool[idx].reshape(B, nb * bs, KV, D).float()
    v = v_pool[idx].reshape(B, nb * bs, KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) / math.sqrt(D)
    pos = torch.arange(nb * bs, device=q.device)
    mask = pos[None, :] < valid_len.long()[:, None]  # (B, S)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v).to(q.dtype)


def work_terms(q: torch.Tensor, k_pool: torch.Tensor,
               block_tables: torch.Tensor, valid_len) -> dict:
    """Bytes the call must move and flops it must do, for these inputs.

    Each input is counted once: q, the live K and V rows (``valid_len``
    rows per slot and KV head), the block-table entries those rows need,
    ``valid_len`` itself, and the output.  Flops: 2 for q.k and 2 for p.v
    per live row, query head and element.
    """
    B, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    lens = [min(int(v), nb * bs) for v in valid_len]
    live = sum(lens)
    tiles = sum(-(-n // bs) for n in lens)
    item = q.element_size()
    bytes_ = (2 * B * KV * G * D * item        # q in, output out
              + 2 * live * KV * D * item       # live K and V rows
              + 4 * tiles + 4 * B)             # table entries, valid_len
    flops = 4.0 * live * KV * G * D
    return {"bytes": float(bytes_), "flops": flops}
