"""Multi-head Latent Attention (DeepSeek-V2): full attention, and the
absorbed one-token step over contiguous latent caches or paged latent
pools, and a chunk step over the pools.

Port of ``init_mla``, ``_q_and_latent``, ``mla_full``,
``mla_full_with_cache``, ``init_mla_cache`` and ``mla_decode`` of
``repro/models/mla.py``, with the reference's parameter names and layouts
(so its sharding rules and parameter trees apply unchanged).  Full
attention decompresses K/V per position and runs the chunked flash path
of :mod:`repro_torch.models.flash` (KV = h, G = 1);
:func:`mla_decode_dense` is the reference's ``mla_decode`` over
contiguous caches, and :func:`mla_decode` its paged counterpart.  The cache
holds, a token, only the RMS-normed latent ``c`` (``kv_lora_rank``) and
the rotated ``k_rope`` (``qk_rope_dim``), in block pools like the K/V
pools or in contiguous caches.  Attention reads them directly in the
*absorbed* form: ``w_uk`` is folded into the query (``q_lat``), a row's
score is ``q_lat . c + q_rope . k_rope`` scaled by ``1/sqrt(qk_nope +
qk_rope)``, and the context stays in latent space until ``w_uv`` and
``wo`` take it out.  Scores, softmax and the context's sums are fp32
whatever the compute dtype (the reference's
``preferred_element_type=float32``; the compute-dtype operands are widened
before the products, which is exact), the probabilities are cast to the
view's dtype before the context product, and the output is in ``x``'s
dtype, as the reference's casts are.

The reference's one-token step reads the cache read-only and merges the
new token in a second softmax step; its chunk step scans that cell over
the chunk.  The port commits first and attends once: :func:`mla_decode`
writes each slot's new latent row into the pools and attends over the
slot's rows ``[0, positions[b]]``, and :func:`mla_chunk` does the same for
the ``w`` rows of every slot at once, row ``r`` attending over rows
``[0, positions[b] + r]``.  Both agree with the reference within
floating-point tolerance, not bit for bit; under int8 pools the new row
attends to its own quantized latent where the reference uses the fresh
row.  A row is committed converted to the pools' dtype or, for int8,
quantized with one fp32 scale a row (amax over the row's latent, as the
reference's ``_quantize_token``); the view is widened back to the compute
dtype (``code * scale`` in the compute dtype, as the reference's gather
does).  Rows past a slot's length, and every row of an idle slot, write
into the null block, as the reference's masked commits do.

Tensor parallelism: under a :class:`~repro_torch.models.layers.MeshContext`
whose rules split the MLA projections over ``model`` (``mla_split``),
``wq``, ``w_uk`` and ``w_uv`` hold this rank's heads and ``wo`` is
row-parallel (summed over ``model`` in fp32); ``w_dkv`` and ``kv_norm`` are
whole, so every model rank computes the same latent rows and the latent
pools are whole on every rank.  Under a data split each rank computes its
own slots' rows, gathers every slot's over ``data`` and commits them all,
so every rank's pools hold every slot's rows, as the K/V pools do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.flash_decode.ref import quantize_rows
from repro_torch.models import layers
from repro_torch.models.attention import commit_rows, valid_lengths
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import MeshContext

NEG_INF = -1e30
#: the physical block that idle slots' and padded rows' commits land in
#: (``transformer.NULL_BLOCK``)
NULL_BLOCK = 0


def init_mla(gen: torch.Generator, cfg, dtype, device) -> dict:
    """``wq``, ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv`` and ``wo`` with the
    reference's names and shapes, each matrix drawn from a generator of
    its own seeded from ``gen``, in parallel threads."""
    d, h, ml = cfg.d_model, cfg.n_heads, cfg.mla
    qd = ml.qk_nope_dim + ml.qk_rope_dim
    names = ("wq", "w_dkv", "w_uk", "w_uv", "wo")
    shapes = ((d, h * qd), (d, ml.kv_lora_rank + ml.qk_rope_dim),
              (ml.kv_lora_rank, h * ml.qk_nope_dim),
              (ml.kv_lora_rank, h * ml.v_head_dim), (h * ml.v_head_dim, d))
    w = layers.truncated_normal_many(gen, shapes, 1.0, dtype, device)
    p = {name: {"w": t} for name, t in zip(names, w)}
    p["kv_norm"] = layers.rms_norm_init(ml.kv_lora_rank, dtype, device)
    return p


def _q_and_latent(params: dict, cfg, x: torch.Tensor,
                  positions: torch.Tensor,
                  mesh: Optional[MeshContext] = None):
    """x (B, S, d), positions (B, S) -> q_nope (B,S,h,nope), q_rope
    (B,S,h,rope) rotated, c (B,S,lora) normed, k_rope (B,S,rope) rotated;
    ``h`` is the heads ``wq`` holds (this rank's under a model split).
    Under a train step's split ``mesh``, the whole latent rows enter this
    rank's heads through :meth:`~MeshContext.copy`."""
    B, S, _ = x.shape
    ml = cfg.mla
    train = _split(mesh) and mesh.train
    xq = mesh.copy(x) if train else x
    q = layers.dense(params["wq"], xq).reshape(
        B, S, -1, ml.qk_nope_dim + ml.qk_rope_dim)
    q_nope, q_rope = q[..., :ml.qk_nope_dim], q[..., ml.qk_nope_dim:]
    ckv = layers.dense(params["w_dkv"], x)
    c, k_rope = ckv[..., :ml.kv_lora_rank], ckv[..., ml.kv_lora_rank:]
    c = layers.rms_norm(params["kv_norm"], c, cfg.norm_eps)
    if train:
        c, k_rope = mesh.copy(c), mesh.copy(k_rope)
    cos, sin = layers.rope_cos_sin(positions, ml.qk_rope_dim, cfg.rope_theta)
    # k_rope as one more head of q_rope: one rotation for both
    rot = layers.apply_rope(torch.cat((q_rope, k_rope[:, :, None, :]), dim=2),
                            cos, sin)
    return q_nope, rot[:, :, :-1], c, rot[:, :, -1]


def _full(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
          causal: bool, mesh: Optional[MeshContext] = None):
    """Decompressed attention over x (B, S, d): K/V of every head from
    the latent rows, the shared ``k_rope`` broadcast to every head, and
    the chunked flash path with KV = h, G = 1.  Returns (y (B, S, d), c
    (B, S, lora), k_rope (B, S, rope)).  Under a train step's split
    ``mesh``, on this rank's heads with ``wo`` row-parallel."""
    B, S, _ = x.shape
    ml = cfg.mla
    q_nope, q_rope, c, k_rope = _q_and_latent(params, cfg, x, positions,
                                              mesh)
    h = q_nope.shape[2]
    k_nope = layers.dense(params["w_uk"], c).reshape(B, S, h, ml.qk_nope_dim)
    v = layers.dense(params["w_uv"], c).reshape(B, S, h, ml.v_head_dim)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, h, ml.qk_rope_dim)], dim=-1)
    out = flash_attention(q_cat[:, :, :, None, :], k_cat, v, causal=causal)
    out = out.reshape(B, S, -1)
    if not _split(mesh):
        return layers.dense(params["wo"], out), c, k_rope
    return (layers.row_parallel(out @ params["wo"]["w"].to(out.dtype),
                                mesh.mesh, params["wo"].get("b")), c, k_rope)


def mla_full(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
             *, causal: bool = True,
             mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Teacher-forced MLA over x (B, S, d), positions (B, S): decompress
    and run the chunked flash path.  Returns (B, S, d).  Under a train
    step's ``mesh`` whose rules split the MLA projections, on this rank's
    heads."""
    return _full(params, cfg, x, positions, causal, mesh)[0]


def mla_full_with_cache(params: dict, cfg, x: torch.Tensor,
                        positions: torch.Tensor):
    """Prefill: causal :func:`mla_full` that also returns the compressed
    cache rows ``{"c": (B, S, lora), "k_rope": (B, S, rope)}``."""
    y, c, k_rope = _full(params, cfg, x, positions, True)
    return y, {"c": c, "k_rope": k_rope}


def init_mla_cache(cfg, batch: int, max_len: int, dtype,
                   layers_stacked: int = 1, device="cuda") -> dict:
    """Zeroed contiguous latent caches: ``c`` (layers_stacked, batch,
    max_len, kv_lora_rank) and ``k_rope`` (layers_stacked, batch, max_len,
    qk_rope_dim), in ``dtype``, on the card unless ``device`` says
    otherwise."""
    ml = cfg.mla
    dev = resolve_device(device)
    lead = (layers_stacked, batch, max_len)
    return {"c": torch.zeros(lead + (ml.kv_lora_rank,), dtype=dtype,
                             device=dev),
            "k_rope": torch.zeros(lead + (ml.qk_rope_dim,), dtype=dtype,
                                  device=dev)}


def mla_decode_dense(params: dict, cfg, x: torch.Tensor,
                     cache_c: torch.Tensor, cache_kr: torch.Tensor, pos,
                     valid_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Absorbed one-token decode over one layer's contiguous latent
    caches, committing in place: the dense counterpart of the reference's
    ``mla_decode``.

    x (B, 1, d); cache_c (B, S, lora) and cache_kr (B, S, rope) in x's
    dtype; pos a host int or a (B,) tensor of per-slot lengths, and
    ``valid_len`` its :func:`~repro_torch.models.attention.valid_lengths`
    (made here when not given).  Each slot's new latent row is written at
    ``pos``, then each slot attends over its rows ``[0, pos]`` in torch
    ops.  Returns (B, 1, d)."""
    if valid_len is None:
        valid_len = valid_lengths(pos, x.shape[0], x.device)
    positions = (valid_len.long() - 1)[:, None]
    q_nope, q_rope, c_new, kr_new = _q_and_latent(params, cfg, x, positions)
    commit_rows(cache_c, c_new, pos)
    commit_rows(cache_kr, kr_new, pos)
    rows = torch.arange(cache_c.shape[1], device=x.device)
    hidden = rows[None, None, None, :] > positions[:, :, None, None]
    return _absorbed(params, cfg, q_nope, q_rope, cache_c, cache_kr, hidden,
                     None)


class StepRows(NamedTuple):
    """What every MLA layer of one step shares (:func:`step_rows`):
    ``pos`` (B_own, w) the positions of this rank's rows, ``dst`` (B * w,)
    the pool row (``block * bs + offset``) each row of every slot commits
    to, and ``hidden`` (B_own, w, 1, S) the view's rows each of this rank's
    rows may not see."""
    pos: torch.Tensor
    dst: torch.Tensor
    hidden: torch.Tensor


def step_rows(positions: torch.Tensor, block_tables: torch.Tensor,
              lengths: torch.Tensor, w: int, bs: int,
              own: slice = slice(None)) -> StepRows:
    """Rows ``r < lengths[b]`` of slot ``b`` sit at ``positions[b] + r``
    and commit there through the block table; every other row commits to
    the null block's row 0, so nothing waits for the device to count the
    live rows.  Row ``r`` of an ``own`` slot sees the view's rows ``[0,
    positions[b] + r]``."""
    nb = block_tables.shape[1]
    rows = torch.arange(w, device=positions.device)
    pos = positions.long()[:, None] + rows
    blk = block_tables.long().gather(1, torch.clamp(pos // bs, max=nb - 1))
    live = rows[None, :] < lengths.long()[:, None]
    dst = torch.where(live, blk * bs + pos % bs, NULL_BLOCK * bs)
    view = torch.arange(nb * bs, device=positions.device)
    hidden = view[None, None, :] > pos[own][:, :, None]
    return StepRows(pos[own], dst.reshape(-1), hidden[:, :, None, :])


def commit_latent(c_new: torch.Tensor, kr_new: torch.Tensor,
                  c_pool: torch.Tensor, kr_pool: torch.Tensor,
                  dst: torch.Tensor, c_scale=None, kr_scale=None) -> None:
    """Write ``c_new`` (B, w, lora) and ``kr_new`` (B, w, rope) into pool
    rows ``dst`` (B * w,) (:func:`step_rows`), in place: converted to the
    pools' dtype, or quantized where ``c_scale``/``kr_scale`` (n_blocks,
    bs) fp32 sit beside int8 pools."""
    B, w, _ = c_new.shape
    for new, pool, scale in ((c_new, c_pool, c_scale),
                             (kr_new, kr_pool, kr_scale)):
        flat = pool.view(-1, pool.shape[-1])
        x = new.reshape(B * w, -1)
        if scale is None:
            flat[dst] = x.to(pool.dtype)
        else:
            codes, s = quantize_rows(x[:, None, :])
            flat[dst] = codes[:, 0]
            scale.view(-1)[dst] = s


def _view(pool: torch.Tensor, scale, block_tables: torch.Tensor,
          dtype) -> torch.Tensor:
    """Each slot's logical rows (B, nb * bs, width) of a latent pool, in
    the compute dtype ``dtype``: int8 codes times their row's scale, both
    cast to ``dtype`` first (the reference's dequantizing gather)."""
    B, nb = block_tables.shape
    idx = block_tables.long()
    g = pool[idx].to(dtype)
    if scale is not None:
        g = g * scale[idx].to(dtype)[..., None]
    return g.reshape(B, nb * pool.shape[1], pool.shape[-1])


def _split(mesh: Optional[MeshContext]) -> bool:
    return mesh is not None and mesh.mla_split


def _all_slots(mesh: Optional[MeshContext], c_new, kr_new):
    """Every slot's new latent rows (this rank's slots on dim 0), in one
    gather over ``data``."""
    if mesh is None or not mesh.split_slots:
        return c_new, kr_new
    both = mesh.mesh.gather(torch.cat((c_new, kr_new), dim=-1), "data")
    return both[..., :c_new.shape[-1]], both[..., c_new.shape[-1]:]


def _attend(params: dict, cfg, x: torch.Tensor, c_pool, kr_pool,
            positions: torch.Tensor, block_tables: torch.Tensor,
            lengths: Optional[torch.Tensor], c_scale, kr_scale,
            mesh: Optional[MeshContext],
            rows: Optional[StepRows]) -> torch.Tensor:
    """The absorbed step for ``w`` rows a slot (every row live where
    ``lengths`` is None): commit every slot's rows, then attend (see
    :func:`mla_chunk`)."""
    w = x.shape[1]
    sl = slice(None) if mesh is None else mesh.slots
    if rows is None:
        live = torch.full_like(positions, w) if lengths is None else lengths
        rows = step_rows(positions, block_tables, live, w, c_pool.shape[1],
                         sl)
    q_nope, q_rope, c_new, kr_new = _q_and_latent(params, cfg, x, rows.pos)
    c_all, kr_all = _all_slots(mesh, c_new, kr_new)
    commit_latent(c_all, kr_all, c_pool, kr_pool, rows.dst, c_scale,
                  kr_scale)
    c = _view(c_pool, c_scale, block_tables[sl], x.dtype)
    kr = _view(kr_pool, kr_scale, block_tables[sl], x.dtype)
    return _absorbed(params, cfg, q_nope, q_rope, c, kr, rows.hidden, mesh)


def _absorbed(params: dict, cfg, q_nope: torch.Tensor, q_rope: torch.Tensor,
              c: torch.Tensor, kr: torch.Tensor, hidden: torch.Tensor,
              mesh: Optional[MeshContext]) -> torch.Tensor:
    """The absorbed attention of ``w`` query rows a slot (q_nope, q_rope
    (B, w, h, .)) over a view of latent rows c (B, S, lora) and kr (B, S,
    rope) in the compute dtype, with the view's rows each query row may
    not see masked by ``hidden`` (B, w, 1, S); then ``w_uv`` and ``wo``.
    Returns (B, w, d)."""
    B, w = q_nope.shape[:2]
    ml = cfg.mla
    dtype = c.dtype
    w_uk = params["w_uk"]["w"].to(dtype).reshape(ml.kv_lora_rank, -1,
                                                  ml.qk_nope_dim)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)
    scale = 1.0 / math.sqrt(ml.qk_nope_dim + ml.qk_rope_dim)
    c32 = c.float()
    s = (torch.einsum("bqhl,bsl->bqhs", q_lat.float(), c32)
         + torch.einsum("bqhr,bsr->bqhs", q_rope.float(), kr.float())
         ) * scale
    s = s.masked_fill(hidden, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ctx = torch.einsum("bqhs,bsl->bqhl", p.to(dtype).float(), c32)
    ctx = (ctx / p.sum(dim=-1)[..., None]).to(dtype)
    w_uv = params["w_uv"]["w"].to(dtype).reshape(ml.kv_lora_rank, -1,
                                                  ml.v_head_dim)
    out = torch.einsum("bqhl,lhv->bqhv", ctx, w_uv).reshape(B, w, -1)
    if not _split(mesh):
        return layers.dense(params["wo"], out)
    return layers.row_parallel(out @ params["wo"]["w"].to(out.dtype),
                               mesh.mesh, params["wo"].get("b"))


def mla_decode(params: dict, cfg, x: torch.Tensor, c_pool: torch.Tensor,
               kr_pool: torch.Tensor, positions: torch.Tensor,
               block_tables: torch.Tensor, c_scale=None, kr_scale=None,
               mesh: Optional[MeshContext] = None,
               rows: Optional[StepRows] = None) -> torch.Tensor:
    """Absorbed one-token decode over one layer's latent pools, committing
    in place.

    x (B, 1, d); c_pool (n_blocks, bs, lora) and kr_pool (n_blocks, bs,
    rope), this layer's pools, with their ``c_scale``/``kr_scale``
    (n_blocks, bs) when they are int8; positions (B,) int32 per-slot cache
    lengths before this token; block_tables (B, nb) int32.  Each slot's
    new latent row is written at ``positions[b]`` through its table (an
    idle slot's all-zero row names the null block), then each slot
    attends over its rows ``[0, positions[b]]``.  Returns (B, 1, d).
    Under ``mesh``, x holds this rank's slots ``mesh.slots``; positions
    and block_tables hold every slot, and every slot's row is committed.
    ``rows`` is :func:`step_rows` of these inputs (with lengths of 1),
    computed here when not given.
    """
    return _attend(params, cfg, x, c_pool, kr_pool, positions, block_tables,
                   None, c_scale, kr_scale, mesh, rows)


def mla_chunk(params: dict, cfg, x: torch.Tensor, c_pool: torch.Tensor,
              kr_pool: torch.Tensor, positions: torch.Tensor,
              block_tables: torch.Tensor, lengths: torch.Tensor,
              c_scale=None, kr_scale=None,
              mesh: Optional[MeshContext] = None,
              rows: Optional[StepRows] = None) -> torch.Tensor:
    """A chunk of ``w`` rows a slot over one layer's latent pools,
    committing in place.

    x (B, w, d); pools, scales, positions and block_tables as
    :func:`mla_decode`; lengths (B,) int32 in [0, w], the slot's real
    rows.  Row ``r < lengths[b]`` sits at ``positions[b] + r`` and is
    committed there; after every slot's rows are committed, row ``r``
    attends over the slot's rows ``[0, positions[b] + r]``.  Rows past
    ``lengths[b]`` commit nothing (their output is finite and
    meaningless).  Returns (B, w, d).  Under ``mesh`` and with ``rows``
    as :func:`mla_decode`; lengths hold every slot.
    """
    return _attend(params, cfg, x, c_pool, kr_pool, positions, block_tables,
                   lengths, c_scale, kr_scale, mesh, rows)
