"""Grouped-query attention with RoPE, qk-norm and bias: full attention,
dense and paged decode, and chunked prefill.

Port of ``init_attention``, ``_project_qkv``, ``attention_full``,
``attention_full_with_cache``, ``init_cache`` and ``attention_decode`` of
``repro/models/attention.py``, and of the attention the reference's paged
cell runs over its gathered view of the block pool.  Full attention (the
teacher-forced forward and the prefill) runs the chunked online softmax of
:mod:`repro_torch.models.flash`.

The reference's decode reads the cache read-only and merges the new token
in a second softmax step.  The port writes the new token's K/V row first
and then attends once, new row included: the dense decode,
:func:`attention_decode`, with two slice copies into the layer's
contiguous cache and one launch of the contiguous flash-decode kernel
(:func:`~repro_torch.kernels.flash_decode.flash_decode`); the paged
decode with one launch of the paged flash-decode kernel, which commits
and attends.  A
chunk of tokens per slot goes the same way in one call: all its rows are
projected together, committed, and attended causally by the chunked-prefill
kernel, where the reference scans its one-token cell over the chunk.  Both
agree with the reference within floating-point tolerance, not bit for bit.

Pools may be stored in another dtype than the model computes in (the
reference's ``kv_dtype``): bf16, or int8 with one fp32 scale a pool row.
Every row is committed converted to the pools' dtype or, for int8,
quantized (a chunk's rows by the commit of the chunked prefill, a decode
step's by the decode kernel, with the same arithmetic), so the new token
attends to its own stored K/V, as the Pallas kernels do; the reference's
cell merges the fresh row unconverted instead.

Under a mesh (a :class:`~repro_torch.models.layers.MeshContext`) each rank
projects q/k/v for its own slots and its own heads (column-parallel), and
``wo`` is row-parallel; a train step's teacher-forced attention runs
:class:`~repro_torch.models.flash._Flash` forward and backward on this
rank's heads the same way.  Where the K/V pools split their heads it attends
over its local heads: the decode through the head-sharded decode kernel,
the chunk through the chunked-prefill kernel.  The pools' block axis is
whole on every rank, and with prefix sharing a slot on one data rank may
read a block that a slot on another wrote, so every rank commits every
slot's new rows: the rows are all-gathered over ``data`` first.  For int8
pools a row's scale is the amax over all its KV heads, so the ranks of a
data row all-reduce (MAX) each row's amax over ``model`` before the commit
quantizes; their codes and scales are then the unsharded commit's head
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.flash_decode import (commit_paged, flash_decode,
                                              flash_decode_paged,
                                              flash_decode_paged_sharded,
                                              flash_prefill_paged)
from repro_torch.kernels.flash_decode.ref import row_amax
from repro_torch.models import layers
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import MeshContext


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
                 positions: torch.Tensor,
                 mesh: Optional[MeshContext] = None):
    """x (B, S, d), positions (B, S) -> q (B,S,H,D), k and v (B,S,KV,D):
    under ``mesh`` the attention's heads, this rank's where the pools
    split their heads (in a train step, where the projections split on
    whole heads) and all of them (gathered over ``model``) where they do
    not."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if mesh is not None and any(mesh.qkv_split):
        x = mesh.copy(x)
    q, k, v = (layers.dense(params[name], x) for name in ("wq", "wk", "wv"))
    if mesh is not None and not mesh.heads:
        q, k, v = (mesh.mesh.gather(t, "model", dim=-1) if split else t
                   for t, split in zip((q, k, v), mesh.qkv_split))
    q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    if cfg.qk_norm:
        qn, kn = params["q_norm"], params["k_norm"]
        if mesh is not None and mesh.heads:  # read on this rank's heads
            qn, kn = ({"scale": mesh.copy(n["scale"])} for n in (qn, kn))
        q = layers.rms_norm(qn, q, cfg.norm_eps)
        k = layers.rms_norm(kn, k, cfg.norm_eps)
    cos, sin = layers.rope_cos_sin(positions, hd, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def train_context(mesh: Optional[MeshContext]) -> Optional[MeshContext]:
    """``mesh`` where it splits the attention's projections, else None:
    the teacher-forced paths take their heads from it."""
    return mesh if mesh is not None and any(mesh.qkv_split) else None


def attention_full(params: dict, cfg, x: torch.Tensor,
                   positions: torch.Tensor, *, causal: bool = True,
                   kv_override=None,
                   mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Teacher-forced attention over a whole sequence: x (B, S, d),
    positions (B, S) -> (B, S, d).  ``kv_override=(k, v)`` (B, Sk, KV, D)
    attends to those keys instead, without the causal mask
    (cross-attention).  Under a train step's ``mesh``, on this rank's
    heads (or every head, gathered, where a split cuts one), ``wo``
    row-parallel."""
    B, S, _ = x.shape
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    mesh = train_context(mesh)
    q, k, v = _project_qkv(params, cfg, x, positions, mesh)
    if kv_override is not None:
        k, v = kv_override
        causal = False
    out = flash_attention(q.reshape(B, S, k.shape[2], -1, hd), k, v,
                          causal=causal)
    return _out_proj(params, out.reshape(B, S, -1), mesh)


def attention_full_with_cache(params: dict, cfg, x: torch.Tensor,
                              positions: torch.Tensor):
    """Prefill: causal attention over x (B, S, d) that also returns the
    layer's K/V rows ``{"k", "v"}`` (B, S, KV, D)."""
    B, S, _ = x.shape
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = flash_attention(q.reshape(B, S, kv, -1, hd), k, v, causal=True)
    return (layers.dense(params["wo"], out.reshape(B, S, -1)),
            {"k": k, "v": v})


def init_cache(cfg, batch: int, max_len: int, dtype, layers_stacked: int = 1,
               device="cuda") -> dict:
    """Zeroed contiguous K/V caches ``(layers_stacked, batch, max_len, KV,
    D)`` in ``dtype``, on the card unless ``device`` says otherwise."""
    shape = (layers_stacked, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {key: torch.zeros(shape, dtype=dtype, device=dev)
            for key in ("k", "v")}


def commit_rows(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B, 1, ...) into the contiguous layer cache ``cache``
    (B, S, ...) at row ``pos``, in place: one slice copy for a host int,
    each slot's own row for a (B,) tensor of per-slot positions."""
    if torch.is_tensor(pos):
        slots = torch.arange(cache.shape[0], device=cache.device)
        cache[slots, pos.to(cache.device).long()] = new[:, 0].to(cache.dtype)
    else:
        cache[:, pos] = new[:, 0].to(cache.dtype)


def valid_lengths(pos, batch: int, device) -> torch.Tensor:
    """(B,) int32 ``pos + 1`` on ``device``: the rows a slot at ``pos``
    (a host int, or a (B,) tensor) attends to once its new row is in."""
    if torch.is_tensor(pos):
        return (pos.to(device=device, dtype=torch.int32) + 1).expand(batch) \
            .contiguous()
    return torch.full((batch,), pos + 1, dtype=torch.int32, device=device)


def attention_decode(params: dict, cfg, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos,
                     valid_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token decode over one layer's contiguous cache, committing in
    place.

    x (B, 1, d); cache_k/cache_v (B, S, KV, D) in x's dtype; pos the
    current length, a host int or a (B,) int tensor of per-slot lengths.
    Each slot's new K/V row is written at ``pos`` first, then each slot
    attends over its rows ``[0, pos]`` in one launch of the contiguous
    flash-decode kernel (its plain version for CPU tensors).
    ``valid_len`` is :func:`valid_lengths` of ``pos``, made here when not
    given (a decode step makes it once for all its layers).  Returns (B,
    1, d)."""
    B = x.shape[0]
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    S = cache_k.shape[1]
    if valid_len is None:
        valid_len = valid_lengths(pos, B, x.device)
    positions = (valid_len.long() - 1)[:, None]
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    commit_rows(cache_k, k_new, pos)
    commit_rows(cache_v, v_new, pos)
    out = flash_decode(q.reshape(B, kv, -1, hd), cache_k, cache_v, valid_len,
                       block_s=S)
    return layers.dense(params["wo"], out.reshape(B, 1, -1))


def _out_proj(params: dict, out: torch.Tensor,
              mesh: Optional[MeshContext]) -> torch.Tensor:
    """``wo`` over the attention output (B, S, heads * D); row-parallel
    where ``wo`` is split, on this rank's columns of the output."""
    if mesh is None or not mesh.wo_split:
        return layers.dense(params["wo"], out)
    w = params["wo"]["w"]
    if not mesh.heads:  # every head attended here: keep this rank's rows
        out = mesh.own(out)
    return layers.row_parallel(out @ w.to(out.dtype), mesh.mesh,
                               params["wo"].get("b"))


def _all_slots(mesh: MeshContext, k_new, v_new):
    """Every slot's new K and V rows (this rank's slots on dim 0), in one
    gather over ``data``."""
    if not mesh.split_slots:
        return k_new, v_new
    both = torch.stack((k_new, v_new), dim=1)
    return mesh.mesh.gather(both, "data").unbind(1)


def _commit_amax(mesh: MeshContext, k_new, v_new, k_scale) -> dict:
    """``k_amax``/``v_amax`` for the commit of int8 rows that hold this
    rank's heads only: each row's amax over all heads, the MAX over
    ``model`` of the local ones (K and V in one all-reduce).  Empty where
    the pools are not int8 or hold every head."""
    if k_scale is None or not mesh.heads or mesh.mesh.axis_size(
            "model") == 1:
        return {}
    amax = mesh.mesh.max(torch.stack((row_amax(k_new), row_amax(v_new))),
                         "model")
    return {"k_amax": amax[0], "v_amax": amax[1]}


def attention_decode_paged(params: dict, cfg, x: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           positions: torch.Tensor,
                           block_tables: torch.Tensor, k_scale=None,
                           v_scale=None,
                           mesh: Optional[MeshContext] = None
                           ) -> torch.Tensor:
    """One-token decode over one layer's block pool, committing in place.

    x (B, 1, d); k/v_pool (n_blocks, bs, KV, D), this layer's pools, with
    their ``k_scale``/``v_scale`` (n_blocks, bs) when they are int8;
    positions (B,) int32 per-slot cache lengths before this token;
    block_tables (B, nb) int32.  One launch of the decode kernel writes
    each slot's new K/V row at ``positions[b]`` through its table (an idle
    slot's all-zero row names the null block), converted to the pools'
    dtype or quantized, and then each slot attends over its rows ``[0,
    positions[b]]``, the new token included.  Returns (B, 1, d).

    Under ``mesh``, x holds this rank's slots ``mesh.slots`` and the pools
    its heads; positions and block_tables hold every slot.  Every slot's
    row is committed: the other data ranks' by the commit kernel first,
    this rank's in its decode launch, through
    :func:`flash_decode_paged_sharded` where the pools split their heads.
    """
    B = x.shape[0]
    hd, g = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    sl = slice(None) if mesh is None else mesh.slots
    q, k_new, v_new = _project_qkv(params, cfg, x, positions[sl, None], mesh)
    kv = k_new.shape[2]
    amax = {}
    if mesh is not None:
        k_all, v_all = _all_slots(mesh, k_new, v_new)
        amax = _commit_amax(mesh, k_all, v_all, k_scale)
        if mesh.split_slots:  # every rank holds every block
            others = torch.ones_like(positions)
            others[sl] = 0
            commit_paged(k_all.contiguous(), v_all.contiguous(), k_pool,
                         v_pool, block_tables, positions, others, k_scale,
                         v_scale, **amax)
        amax = {key: a[sl, 0] for key, a in amax.items()}
    args = (q.reshape(B, kv, g, hd), k_pool, v_pool, block_tables[sl],
            positions[sl] + 1)
    new = dict(k_new=k_new.reshape(B, kv, hd), v_new=v_new.reshape(B, kv, hd),
               **amax)
    if mesh is not None and mesh.heads:
        out = flash_decode_paged_sharded(*args, mesh=mesh.mesh,
                                         k_scale=k_scale, v_scale=v_scale,
                                         **new)
    else:
        out = flash_decode_paged(*args, k_scale, v_scale, **new)
    return _out_proj(params, out.reshape(B, 1, kv * g * hd), mesh)


def attention_prefill_paged(params: dict, cfg, x: torch.Tensor,
                            k_pool: torch.Tensor, v_pool: torch.Tensor,
                            positions: torch.Tensor,
                            block_tables: torch.Tensor,
                            lengths: torch.Tensor, k_scale=None,
                            v_scale=None,
                            mesh: Optional[MeshContext] = None
                            ) -> torch.Tensor:
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

    Under ``mesh``, x holds this rank's slots ``mesh.slots`` and the pools
    its heads; positions, block_tables and lengths hold every slot.  The
    other data ranks' rows are committed first, then this rank's slots
    commit and attend through the chunked-prefill kernel, so every row is
    in the pools before any slot attends, as in one unsharded call.
    """
    B, w, _ = x.shape
    hd, g = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    sl = slice(None) if mesh is None else mesh.slots
    pos = positions[sl, None] + torch.arange(w, dtype=positions.dtype,
                                             device=positions.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos, mesh)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    kv = k_new.shape[2]
    amax = {}
    if mesh is not None:
        k_all, v_all = _all_slots(mesh, k_new, v_new)
        amax = _commit_amax(mesh, k_all, v_all, k_scale)
        if mesh.split_slots:  # every rank holds every block
            others = lengths.clone()
            others[sl] = 0
            commit_paged(k_all.contiguous(), v_all.contiguous(), k_pool,
                         v_pool, block_tables, positions, others, k_scale,
                         v_scale, **amax)
        amax = {key: a[sl] for key, a in amax.items()}
    out = flash_prefill_paged(
        q.reshape(B, w, kv, g, hd), k_new, v_new, k_pool, v_pool,
        block_tables[sl], positions[sl], lengths[sl], k_scale, v_scale,
        **amax)
    return _out_proj(params, out.reshape(B, w, kv * g * hd), mesh)
