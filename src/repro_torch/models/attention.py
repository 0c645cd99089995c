"""Grouped-query attention with RoPE, qk-norm and bias: paged decode and
chunked prefill.

Port of ``init_attention`` and ``_project_qkv`` of
``repro/models/attention.py``, and of the attention the reference's paged
cell runs over its gathered view of the block pool.  The reference reads
the cache read-only and merges the new token in a second softmax step; the
port first writes the new token's K/V row into the pool and then attends
over the pool with the paged flash-decode kernel.  A chunk of tokens per
slot goes the same way in one call: all its rows are projected together,
committed, and attended causally by the chunked-prefill kernel, where the
reference scans its one-token cell over the chunk.  Both agree with the
reference within floating-point tolerance, not bit for bit.

Pools may be stored in another dtype than the model computes in (the
reference's ``kv_dtype``): bf16, or int8 with one fp32 scale a pool row.
Every row is committed by the commit kernel of the chunked prefill (a
decode step's row is a chunk of one), converted to the pools' dtype or,
for int8, quantized, so the new token attends to its own stored K/V, as
the Pallas kernels do; the reference's cell merges the fresh row
unconverted instead.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode import (commit_paged,
                                              flash_decode_paged,
                                              flash_prefill_paged)
from repro_torch.models import layers


def init_attention(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": layers.dense_init(gen, d, h * hd, dtype, device,
                                bias=cfg.qkv_bias),
        "wk": layers.dense_init(gen, d, kv * hd, dtype, device,
                                bias=cfg.qkv_bias),
        "wv": layers.dense_init(gen, d, kv * hd, dtype, device,
                                bias=cfg.qkv_bias),
        "wo": layers.dense_init(gen, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rms_norm_init(hd, dtype, device)
        p["k_norm"] = layers.rms_norm_init(hd, dtype, device)
    return p


def _project_qkv(params: dict, cfg, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, d), positions (B, S) -> q (B,S,H,D), k and v (B,S,KV,D)."""
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = layers.dense(params["wq"], x).reshape(B, S, h, hd)
    k = layers.dense(params["wk"], x).reshape(B, S, kv, hd)
    v = layers.dense(params["wv"], x).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = layers.rms_norm(params["k_norm"], k, cfg.norm_eps)
    cos, sin = layers.rope_cos_sin(positions, hd, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def attention_decode_paged(params: dict, cfg, x: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           positions: torch.Tensor,
                           block_tables: torch.Tensor, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """One-token decode over one layer's block pool, committing in place.

    x (B, 1, d); k/v_pool (n_blocks, bs, KV, D), this layer's pools, with
    their ``k_scale``/``v_scale`` (n_blocks, bs) when they are int8;
    positions (B,) int32 per-slot cache lengths before this token;
    block_tables (B, nb) int32.  The commit kernel writes each slot's new
    K/V row at ``positions[b]`` through its table (an idle slot's all-zero
    row names the null block), converted to the pools' dtype or
    quantized; then each slot attends over its rows ``[0,
    positions[b]]``, the new token included.  Returns (B, 1, d).
    """
    B = x.shape[0]
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kv
    q, k_new, v_new = _project_qkv(params, cfg, x, positions[:, None])
    commit_paged(k_new.contiguous(), v_new.contiguous(), k_pool, v_pool,
                 block_tables, positions, torch.ones_like(positions),
                 k_scale, v_scale)
    out = flash_decode_paged(q.reshape(B, kv, g, hd), k_pool, v_pool,
                             block_tables, positions + 1, k_scale, v_scale)
    return layers.dense(params["wo"], out.reshape(B, 1, kv * g * hd))


def attention_prefill_paged(params: dict, cfg, x: torch.Tensor,
                            k_pool: torch.Tensor, v_pool: torch.Tensor,
                            positions: torch.Tensor,
                            block_tables: torch.Tensor,
                            lengths: torch.Tensor, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    """A chunk of ``w`` tokens per slot over one layer's block pool,
    committing in place.

    x (B, w, d); k/v_pool (n_blocks, bs, KV, D), this layer's pools, with
    their ``k_scale``/``v_scale`` (n_blocks, bs) when they are int8;
    positions (B,) int32 per-slot cache lengths before the chunk;
    block_tables (B, nb) int32; lengths (B,) int32 in [0, w], the slot's
    real rows.  Row ``c < lengths[b]`` sits at ``positions[b] + c``, is
    committed there and attends over the slot's rows up to it; rows past
    ``lengths[b]`` commit nothing and their attention output is zero.
    Returns (B, w, d).
    """
    B, w, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kv
    pos = positions[:, None] + torch.arange(w, dtype=positions.dtype,
                                            device=positions.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos)
    out = flash_prefill_paged(
        q.reshape(B, w, kv, g, hd), k_new.contiguous(), v_new.contiguous(),
        k_pool, v_pool, block_tables, positions, lengths, k_scale, v_scale)
    return layers.dense(params["wo"], out.reshape(B, w, kv * g * hd))
