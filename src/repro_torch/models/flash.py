"""Chunked online-softmax attention with a memory-lean backward.

Port of ``repro/models/flash.py``, tile for tile: q tiles of ``q_chunk``
rows walk k tiles of ``k_chunk`` rows with a running (max, sum, acc) in
fp32, so no (Sq, Sk) score tensor is ever materialised.  The reference's
tiles are a ``lax.scan`` of ``jnp`` ops, with no Pallas kernel under them;
the port's are torch ops in the same order.  Products of compute-dtype
operands are widened to fp32 first (exact), as the reference's
``preferred_element_type=float32`` accumulates them.

Backward: the reference's custom VJP, a FlashAttention-2 style recompute,
is :class:`_Flash`, a ``torch.autograd.Function`` whose only saved tensors
are ``(q, k, v, out, lse)``.  :func:`_bwd_impl` recomputes each tile's
probabilities from the saved ``lse`` in the reference's q-tile then k-tile
order and accumulates ``dq``, ``dk`` and ``dv`` in fp32 (GQA's ``dk`` and
``dv`` summed over the G query heads of a KV head), then casts them to the
inputs' dtypes.  The ``kv_valid_len`` path (serving) is forward only, as
in the reference.

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


def _bwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
              causal: bool, q_offset: int, q_chunk: int, k_chunk: int):
    """(dq, dk, dv) in q's, k's and v's dtypes: the reference's
    ``_bwd_impl``.  Each (q tile, k tile) recomputes ``p = exp(s - lse)``
    from the saved ``lse``; ``dq`` sums over the k tiles of its q tile,
    ``dk`` and ``dv`` over the q tiles of their k tile, in fp32."""
    B, Sq, KV, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qc = min(q_chunk, Sq)
    kc = min(k_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    dev = q.device

    delta = (dout.float() * out.float()).sum(dim=-1)  # (B, Sq, KV, G)
    qp = _pad_to(q, 1, nq * qc).reshape(B, nq, qc, KV, G, D)
    dop = _pad_to(dout, 1, nq * qc).reshape(B, nq, qc, KV, G, Dv)
    # (B, KV, G, nq, qc): a tile's rows broadcast against its scores
    lsep = _pad_to(lse, 1, nq * qc).reshape(B, nq, qc, KV, G) \
        .permute(0, 3, 4, 1, 2)
    dlp = _pad_to(delta, 1, nq * qc).reshape(B, nq, qc, KV, G) \
        .permute(0, 3, 4, 1, 2)
    kp = _pad_to(k, 1, nk * kc).reshape(B, nk, kc, KV, D)
    vp = _pad_to(v, 1, nk * kc).reshape(B, nk, kc, KV, Dv)

    dk_acc = torch.zeros((B, nk, kc, KV, D), dtype=torch.float32, device=dev)
    dv_acc = torch.zeros((B, nk, kc, KV, Dv), dtype=torch.float32,
                         device=dev)
    dq_tiles = []
    for qi in range(nq):
        q_tile = qp[:, qi].float()
        do_tile = dop[:, qi].float()
        lse_tile = lsep[:, :, :, qi, :, None]
        dl_tile = dlp[:, :, :, qi, :, None]
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        dq_acc = torch.zeros((B, qc, KV, G, D), dtype=torch.float32,
                             device=dev)
        for ki in range(nk):
            k_tile, v_tile = kp[:, ki].float(), vp[:, ki].float()
            k_pos = ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgd,bckd->bkgqc", q_tile, k_tile) * scale
            mask = _mask_for(q_pos, k_pos, Sk, causal, None)
            s = s.masked_fill(~mask[None, None, None], NEG_INF)
            p = torch.exp(s - lse_tile)  # (B, KV, G, qc, kc)
            dv_acc[:, ki] += torch.einsum("bkgqc,bqkgd->bckd", p, do_tile)
            dp = torch.einsum("bqkgd,bckd->bkgqc", do_tile, v_tile)
            ds = p * (dp - dl_tile) * scale
            dq_acc = dq_acc + torch.einsum("bkgqc,bckd->bqkgd", ds, k_tile)
            dk_acc[:, ki] += torch.einsum("bkgqc,bqkgd->bckd", ds, q_tile)
        dq_tiles.append(dq_acc)
    dq = torch.cat(dq_tiles, dim=1)[:, :Sq]
    dk = dk_acc.reshape(B, nk * kc, KV, D)[:, :Sk]
    dv = dv_acc.reshape(B, nk * kc, KV, Dv)[:, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward by
    :func:`_fwd_impl`, saving only ``(q, k, v, out, lse)``; backward by
    :func:`_bwd_impl`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, q_chunk, k_chunk):
        out, lse = _fwd_impl(q, k, v, causal=causal, q_offset=q_offset,
                             q_chunk=q_chunk, k_chunk=k_chunk,
                             kv_valid_len=None)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, q_offset=q_offset, q_chunk=q_chunk,
                        k_chunk=k_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_impl(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, q_chunk: int = 2048,
                    k_chunk: int = 1024,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Returns (B, Sq, KV, G, Dv) in v's dtype.  ``q_offset`` shifts the
    causal mask (query row ``i`` sits at ``q_offset + i``);
    ``kv_valid_len`` (a scalar) hides the key rows at or past it.
    Differentiable in q, k and v by the FA2-style recompute of
    :class:`_Flash`; the ``kv_valid_len`` path is forward only."""
    if kv_valid_len is None:
        return _Flash.apply(q, k, v, causal, q_offset, q_chunk, k_chunk)
    out, _ = _fwd_impl(q, k, v, causal=causal, q_offset=q_offset,
                       q_chunk=q_chunk, k_chunk=k_chunk,
                       kv_valid_len=kv_valid_len)
    return out
