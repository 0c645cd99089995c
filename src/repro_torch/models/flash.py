"""Chunked online-softmax attention: the forward of the reference's flash
path.

Port of ``_pad_to``, ``_mask_for``, ``_fwd_impl`` and ``flash_attention``
of ``repro/models/flash.py``, tile for tile: q tiles of ``q_chunk`` rows
walk k tiles of ``k_chunk`` rows with a running (max, sum, acc) in fp32,
so no (Sq, Sk) score tensor is ever materialised.  The reference's tiles
are a ``lax.scan`` of ``jnp`` ops, with no Pallas kernel under them; the
port's are torch ops in the same order.  Products of compute-dtype
operands are widened to fp32 first (exact), as the reference's
``preferred_element_type=float32`` accumulates them.

Forward only: the call sites (``attention_full``, ``mla_full`` and their
prefill twins) run without autograd.  The reference's custom VJP (an
FA2-style recompute from ``(q, k, v, out, lse)``) comes with the training
path, ROADMAP item 1.18, as a ``torch.autograd.Function`` over
:func:`_fwd_impl`, which already returns ``lse`` for it.

All tensors: q (B, Sq, KV, G, D); k/v (B, Sk, KV, D[v]); GQA via the G dim.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pad_to(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``axis`` to ``size`` rows."""
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    cfg = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, cfg)


def _mask_for(q_pos: torch.Tensor, k_pos: torch.Tensor, Sk: int,
              causal: bool, kv_valid_len) -> torch.Tensor:
    """(qc, kc) bool: key rows inside the keys, below ``kv_valid_len``
    and, when ``causal``, at or before the query's position."""
    mask = k_pos[None, :] < Sk
    if kv_valid_len is not None:
        mask = mask & (k_pos[None, :] < kv_valid_len)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    return mask


def _fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: int, q_chunk: int, k_chunk: int,
              kv_valid_len):
    """(out (B, Sq, KV, G, Dv) in v's dtype, lse (B, Sq, KV, G) fp32)."""
    B, Sq, KV, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qc = min(q_chunk, Sq)
    kc = min(k_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    dev = q.device
    if torch.is_tensor(kv_valid_len):
        kv_valid_len = kv_valid_len.to(dev)

    qp = _pad_to(q, 1, nq * qc).reshape(B, nq, qc, KV, G, D)
    kp = _pad_to(k, 1, nk * kc).reshape(B, nk, kc, KV, D)
    vp = _pad_to(v, 1, nk * kc).reshape(B, nk, kc, KV, Dv)

    outs, lses = [], []
    for qi in range(nq):
        q_tile = qp[:, qi].float()
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, qc, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_tile, v_tile = kp[:, ki], vp[:, ki]
            k_pos = ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgd,bckd->bkgqc", q_tile,
                             k_tile.float()) * scale
            mask = _mask_for(q_pos, k_pos, Sk, causal, kv_valid_len)
            s = s.masked_fill(~mask[None, None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd",
                              p.to(v_tile.dtype).float(), v_tile.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
        lses.append(m + torch.log(l.clamp_min(1e-30)))
    # (B, KV, G, nq * qc, Dv) -> (B, nq * qc, KV, G, Dv)
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)[:, :Sq]
    lse = torch.cat(lses, dim=3).permute(0, 3, 1, 2)[:, :Sq]
    return out.to(v.dtype), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, q_chunk: int = 2048,
                    k_chunk: int = 1024,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Returns (B, Sq, KV, G, Dv) in v's dtype.  ``q_offset`` shifts the
    causal mask (query row ``i`` sits at ``q_offset + i``);
    ``kv_valid_len`` (a scalar) hides the key rows at or past it."""
    out, _ = _fwd_impl(q, k, v, causal=causal, q_offset=q_offset,
                       q_chunk=q_chunk, k_chunk=k_chunk,
                       kv_valid_len=kv_valid_len)
    return out
