"""Decoder-only LM core of the port: the teacher-forced forward (the
train path, with image embeddings and remat) and its loss, prefill and a
dense decode, and paged decode and chunked prefill, for attention (GQA or
MLA), SSM and hybrid models with dense or MoE FFNs.

Port of the serving paths of ``repro/models/transformer.py`` for
architectures whose layers are attention layers (grouped-query, or
multi-head latent attention, :mod:`repro_torch.models.mla`, where
``cfg.mla`` is set) or Mamba-2 mixers
(:mod:`repro_torch.models.ssm`), each followed by a dense SwiGLU FFN, an
MoE FFN (:mod:`repro_torch.models.moe`) or, where ``d_ff`` is 0, none:
``init_lm``, ``init_paged_cache``, ``paged_block_bytes``,
``copy_paged_block``, ``reset_paged_slots``, ``slot_state``,
``restore_slot_state``, ``decode_step_paged`` and ``prefill_step_paged``,
with the reference's pool storage dtypes (:data:`KV_DTYPES`); the
dense path of the wave scheduler: ``forward``, ``prefill``, ``init_cache``
and ``decode_step`` over contiguous caches, every slot at one position
(the dense decode's grouped-query attention runs the contiguous
flash-decode kernel); and the train path: ``forward`` with image
embeddings before the text (the VLM stub) and a remat policy
(:data:`REMAT_POLICIES`), differentiable through every mixer and FFN,
and ``lm_loss``.  Layer
``i`` takes its kind from the superblock (:func:`layer_kind`).  The
reference's ``first_block`` and its ``lax.scan`` over stacked
superblocks become one list of per-layer
parameter dicts; the cache holds one stack of K/V pools (for MLA, of
``c``/``k_rope`` latent pools) over the attention layers and one of
recurrent states over the mamba layers
(:func:`layer_pools` maps a layer to its index in its stack), and both are
updated in place instead of being rebuilt, which saves a copy of the pool
per step.  The reference's ``prefill_step_paged`` scans its one-token cell
over the chunk; the port computes the chunk in parallel, every row of
every slot through each layer at once: attention through the
chunked-prefill kernel (an MLA layer in the absorbed form,
``mla_chunk``), a mamba mixer in the SSD dual form from each
slot's state (``mamba_chunk``), and an MoE layer's rows routed one chunk
row at a time (``moe_ffn_rows``), as the scanned cell does.
:func:`params_from_numpy` carries the reference's parameters across.

Tensor-parallel serving: with ``mesh=`` (a rank's
:class:`~repro_torch.launch.mesh.ServeMesh`), :func:`init_lm` and
:func:`params_from_numpy` give this rank's shards of the parameters and
:func:`init_paged_cache` its pools (heads split over ``model``, blocks and
scales whole) and states, by the rules of
:mod:`repro_torch.distributed.sharding` (expert stacks split their experts
over ``model``; MLA projections split their heads and the latent pools
are whole; mamba mixers and their states split over ``model`` on a
model-only mesh, states over ``data`` on a data-only one, and both are
whole on a 2-D mesh).  The steps then take
every slot's tokens and tables, run this rank's slots
(:func:`~repro_torch.distributed.sharding.local_slots`) on its shards, and
return those slots' logits, gathered over ``model``.  A train step on a
mesh of ranks runs :func:`forward` under a train
:class:`~repro_torch.models.layers.MeshContext` on its data rank's rows
and its shards by the train rules
(:func:`~repro_torch.distributed.sharding.param_shardings`), every split
region differentiable (:mod:`repro_torch.distributed.tensor_parallel`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding
from repro_torch.models import attention, layers, mla, moe, ssm

#: Physical block 0 is reserved as the NULL block: block tables of idle
#: serving slots point at it, so their writes land in rows no live request
#: reads.
NULL_BLOCK = 0

#: KV pool storage dtypes: "f32" keeps the pool in the model's compute
#: dtype, "bf16" stores bf16, "int8" stores int8 codes with one fp32 scale
#: a pool row (``k_scale``/``v_scale`` pools beside ``k``/``v``, and
#: ``c_scale``/``k_rope_scale`` beside an MLA model's ``c``/``k_rope``).
KV_DTYPES = ("f32", "bf16", "int8")

#: the cache leaves indexed by physical block (the K/V or latent pools and
#: their int8 scales); the recurrent states are indexed by slot
_BLOCK_KEYS = ("k", "v", "k_scale", "v_scale",
               "c", "k_rope", "c_scale", "k_rope_scale")
_STATE_KEYS = ("ssm_state", "conv_state")


def check_served(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is an architecture the port runs: dense (GQA,
    with qk-norm, QKV bias or OLMo's non-parametric LayerNorm), VLM (a
    dense LM behind the image-embedding stub) or MoE attention models
    (grouped-query or MLA), and SSM or hybrid models of attention layers
    and Mamba-2 mixers, with dense, MoE or no FFNs."""
    kinds = set(cfg.layer_pattern)
    mixers = {LayerKind.ATTN, LayerKind.MAMBA}
    family_ok = {
        "dense": cfg.moe is None and kinds == {LayerKind.ATTN},
        "vlm": cfg.moe is None and kinds == {LayerKind.ATTN},
        "moe": cfg.moe is not None and kinds == {LayerKind.ATTN},
        "ssm": LayerKind.MAMBA in kinds,
        "hybrid": kinds == mixers,
    }.get(cfg.family, False)
    if (not family_ok or not kinds <= mixers
            or (LayerKind.MAMBA in kinds) != (cfg.ssm is not None)
            or cfg.is_encoder_decoder):
        raise ValueError(
            f"{cfg.name}: this path runs dense, VLM, MoE (with GQA or MLA), "
            f"SSM and hybrid (attention and Mamba-2) models; an "
            f"encoder-decoder arch trains, prefills and decodes through "
            f"models/whisper.py's forward, prefill and decode_step (ROADMAP "
            f"item 1.18.2), and the serve engine refuses it, as the "
            f"reference's does"
        )


def layer_kind(cfg: ModelConfig, i: int) -> LayerKind:
    """The mixer of layer ``i``: a ``first_dense`` first layer is an
    attention layer, and each stacked layer takes its superblock slot's
    kind (the offset rule of :func:`is_moe_layer`)."""
    offset = 1 if cfg.moe is not None and cfg.moe.first_dense else 0
    if i < offset:
        return LayerKind.ATTN
    return cfg.superblock[(i - offset) % len(cfg.superblock)]


def layer_pools(cfg: ModelConfig) -> list:
    """``(kind, j)`` of every layer: its mixer, and its index in the
    cache's stack of that kind (the K/V pools of the attention layers,
    the states of the mamba layers), in layer order."""
    seen = {LayerKind.ATTN: 0, LayerKind.MAMBA: 0}
    out = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def count_layers(cfg: ModelConfig, kind: LayerKind) -> int:
    """How many layers have mixer ``kind``: the depth of its stack."""
    return sum(k == kind for k, _ in layer_pools(cfg))


def has_state(cfg: ModelConfig) -> bool:
    """Whether the model keeps per-slot recurrent state (mamba layers)."""
    return count_layers(cfg, LayerKind.MAMBA) > 0


def is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether layer ``i`` has an MoE FFN, by the reference's rule: a
    ``first_dense`` first layer is dense, and each stacked layer follows
    its superblock slot (``_slot_is_moe``)."""
    if cfg.moe is None:
        return False
    offset = 1 if cfg.moe.first_dense else 0
    if i < offset:
        return False
    return cfg._is_moe_layer(offset + (i - offset) % len(cfg.superblock))


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda",
            mesh=None, draw_device="cpu", place=None) -> Dict[str, Any]:
    """The port's own seeded init (it does not reproduce the reference's
    numbers; use :func:`params_from_numpy` for those).  With ``mesh``,
    this rank's shards of the same numbers (drawn whole on the CPU, then
    cut).

    The numbers are drawn on ``draw_device``: on the CPU by default, so
    that they do not depend on the device the model runs on; on the card
    (``draw_device="cuda"``) they are other numbers of the same law, drawn
    in seconds where the CPU takes a minute for a full-width model of
    billions of parameters.

    With ``place``, each block of leaves (the embedding, a norm, a layer's
    mixer or FFN) goes through ``place(path, block)`` as soon as it is
    drawn, ``path`` its keys in the tree (``("layers", 3, "moe")``), and
    the tree keeps what it returns; the draws are the same either way."""
    check_served(cfg)
    if mesh is not None:
        return shard_params(init_lm(cfg, seed=seed, device="cpu",
                                    draw_device=draw_device), mesh, device)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(resolve_device(draw_device)).manual_seed(seed)
    norm_init, _ = layers.make_norm(cfg)
    put = place or (lambda _, block: block)
    params: Dict[str, Any] = {
        "embed": put(("embed",), layers.embed_init(
            gen, cfg.vocab_padded, cfg.d_model, dtype, dev)),
        "final_norm": put(("final_norm",), norm_init(dtype, dev)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = put(("lm_head",), layers.dense_init(
            gen, cfg.d_model, cfg.vocab_padded, dtype, dev))
    params["layers"] = []
    for i in range(cfg.n_layers):
        layer: Dict[str, Any] = {}

        def add(name, block, i=i, layer=layer):
            layer[name] = put(("layers", i, name), block)

        add("norm1", norm_init(dtype, dev))
        if is_moe_layer(cfg, i) or cfg.d_ff > 0:
            add("norm2", norm_init(dtype, dev))
        if layer_kind(cfg, i) == LayerKind.ATTN and cfg.mla is not None:
            add("mla", mla.init_mla(gen, cfg, dtype, dev))
        elif layer_kind(cfg, i) == LayerKind.ATTN:
            add("attn", attention.init_attention(gen, cfg, dtype, dev))
        else:
            add("mamba", ssm.init_mamba(gen, cfg, dtype, dev))
        if is_moe_layer(cfg, i):
            add("moe", moe.init_moe(gen, cfg, dtype, dev))
        elif cfg.d_ff > 0:  # d_ff 0: a pure mamba block, mixer only
            add("ffn", layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                          dev))
        params["layers"].append(layer)
    return params


def shard_params(params: Dict[str, Any], mesh, device="cuda"
                 ) -> Dict[str, Any]:
    """This rank's shards of full parameters (by
    :func:`~repro_torch.distributed.sharding.serve_param_shardings`), as
    contiguous tensors of their own on ``device``."""
    dev = resolve_device(device)
    return sharding.map_paths(
        sharding.local_params(params, mesh), lambda _, t: t.to(dev).clone(
            memory_format=torch.contiguous_format))


def _map_tree(tree: Mapping, fn) -> Dict[str, Any]:
    return {k: _map_tree(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda", *,
                      mesh=None, dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``np.asarray`` of every leaf of ``repro.train.steps.init_model``) as
    the port's parameters.

    Leaves widen through float32, which is exact for bf16 (``np.asarray``
    of a bf16 JAX leaf is an ``ml_dtypes.bfloat16`` array, which
    ``torch.from_numpy`` rejects), and are copied, since such buffers are
    read-only.  The router and a mixer's ``A_log``, ``D`` and ``dt_bias``
    stay fp32, as the reference keeps them.  The first layer's
    ``first_block`` (with ``first_dense``) becomes layer 0, and slot ``i``
    of superblock ``s`` (``blocks/slot{i}/...``, row ``s`` of each
    stacked leaf) layer ``s * len(superblock) + i`` after it.  With
    ``mesh`` each leaf is cut to this rank's shard by the reference's
    rules (:func:`~repro_torch.distributed.sharding.serve_param_shardings`)
    before it is converted.  With ``dtype`` every leaf takes that dtype:
    a tree of the parameters' shape that is not parameters (an optimizer
    state's moments or masters, gradients) carries across the same way.
    """
    check_served(cfg)
    dev = resolve_device(device)
    fixed = dtype is not None
    if not fixed:
        dtype = torch_dtype(cfg.param_dtype)
    first = cfg.moe is not None and cfg.moe.first_dense
    keys = {"embed", "final_norm", "lm_head", "blocks"}
    if first:
        keys.add("first_block")
    slots = [f"slot{i}" for i in range(len(cfg.superblock))]
    if (set(tree) - keys or set(tree["blocks"]) != set(slots)
            or first != ("first_block" in tree)):
        raise ValueError(f"not a parameter tree of {cfg.name}: keys "
                         f"{sorted(tree)}")
    if mesh is not None:
        tree = sharding.local_params(_map_tree(tree, np.asarray), mesh)

    def leaf(a, to=dtype) -> torch.Tensor:
        arr = np.array(a, dtype=np.float32, copy=True)
        return torch.from_numpy(arr).to(device=dev, dtype=to)

    def layer(sub: Mapping, pick=lambda a: a) -> Dict[str, Any]:
        out = _map_tree(sub, lambda a: leaf(pick(a)))
        fp32 = [("moe", "router")] + [("mamba", k)
                                      for k in ("A_log", "D", "dt_bias")]
        for group, key in fp32:
            if group in sub and not fixed:
                out[group][key] = leaf(pick(sub[group][key]), torch.float32)
        return out

    params = {k: _map_tree(tree[k], leaf)
              for k in ("embed", "final_norm", "lm_head") if k in tree}
    params["layers"] = [layer(tree["first_block"])] if first else []
    params["layers"] += [
        layer(tree["blocks"][slot], lambda a, s=s: np.asarray(a)[s])
        for s in range(cfg.n_superblocks) for slot in slots
    ]
    return params


def _pool_dtype(cfg: ModelConfig, kv_dtype: str) -> torch.dtype:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    if kv_dtype == "bf16":
        return torch.bfloat16
    if kv_dtype == "int8":
        return torch.int8
    return torch_dtype(cfg.compute_dtype)


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     block_size: int, device="cuda", *,
                     kv_dtype: str = "f32", mesh=None) -> Dict[str, Any]:
    """Zeroed paged K/V pools ``(n_attn, n_blocks, block_size, KV, D)``
    over the attention layers, with ``n_blocks = 1 + slots * max_len /
    block_size``: every slot at full length plus the :data:`NULL_BLOCK`;
    for an MLA model, latent pools ``c`` ``(n_attn, n_blocks, block_size,
    kv_lora_rank)`` and ``k_rope`` ``(n_attn, n_blocks, block_size,
    qk_rope_dim)`` in their place.  ``kv_dtype`` (one of
    :data:`KV_DTYPES`) selects their storage dtype; ``"int8"`` adds zeroed
    fp32 ``<pool>_scale`` pools ``(n_attn, n_blocks, block_size)``, one
    scale a committed row.  A model with
    mamba layers also gets their zeroed recurrent states, indexed by
    slot and never quantized: ``ssm_state`` ``(n_mamba, slots, nh,
    d_state, head_dim)`` fp32 and ``conv_state`` ``(n_mamba, slots, d_conv
    - 1, conv_ch)`` in the compute dtype.  A stack with no layer is left
    out.  With ``mesh``, this rank's leaves by
    :func:`~repro_torch.distributed.sharding.paged_cache_spec`: ``KV /
    model`` heads where ``model`` divides KV, the latent pools and the
    scales whole, the states
    split by heads and channels over ``model`` or by slots over
    ``data``."""
    check_served(cfg)
    if max_len % block_size:
        raise ValueError(f"max_len {max_len} not a multiple of block_size "
                         f"{block_size}")
    dtype = _pool_dtype(cfg, kv_dtype)
    dev = resolve_device(device)
    n_blocks = 1 + slots * (max_len // block_size)
    n_attn = count_layers(cfg, LayerKind.ATTN)
    n_mamba = count_layers(cfg, LayerKind.MAMBA)
    shapes = {}
    if n_attn:
        rows = (n_attn, n_blocks, block_size)
        ml = cfg.mla
        shapes = ({"c": (rows + (ml.kv_lora_rank,), dtype),
                   "k_rope": (rows + (ml.qk_rope_dim,), dtype)}
                  if ml is not None else
                  {key: (rows + (cfg.n_kv_heads, cfg.head_dim), dtype)
                   for key in ("k", "v")})
        if kv_dtype == "int8":
            for key in list(shapes):
                shapes[key + "_scale"] = (rows, torch.float32)
    if n_mamba:
        shapes.update(ssm.cache_shapes(cfg, slots, n_mamba,
                                       torch_dtype(cfg.compute_dtype)))
    if mesh is not None:
        shapes = {key: (sharding.local_shape(
            s, sharding.paged_cache_spec(key, s, mesh), mesh), dt)
            for key, (s, dt) in shapes.items()}
    return {key: torch.zeros(s, dtype=dt, device=dev)
            for key, (s, dt) in shapes.items()}


def paged_block_bytes(cfg: ModelConfig, block_size: int,
                      kv_dtype: str = "f32") -> int:
    """Bytes one physical block stores across every attention layer, its
    fp32 scales included for int8 (0 for a model without attention: its
    states are per slot, not per block).  A row holds K and V, or for MLA
    the latent ``c`` and ``k_rope`` (``kv_lora_rank + qk_rope_dim``
    elements)."""
    itemsize = _pool_dtype(cfg, kv_dtype).itemsize
    row_elems = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
                 if cfg.mla is not None
                 else 2 * cfg.n_kv_heads * cfg.head_dim)
    per_layer = block_size * row_elems * itemsize
    if kv_dtype == "int8":
        per_layer += 2 * block_size * 4  # one fp32 scale a row a pool
    return count_layers(cfg, LayerKind.ATTN) * per_layer


def copy_paged_block(cache: Dict[str, Any], src: int, dst: int
                     ) -> Dict[str, Any]:
    """Copy physical block ``src`` into ``dst`` on every K/V or latent pool
    of every attention layer, scales included, in place; returns the same
    dict.
    The device half of copy-on-write.  The recurrent states are per slot,
    not per block, and pass through."""
    for key in _BLOCK_KEYS:
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    return cache


def reset_paged_slots(cache: Dict[str, Any], mask, *, mesh=None
                      ) -> Dict[str, Any]:
    """Zero both recurrent states of every slot where ``mask`` (B,) bool
    is set, in place; returns the same dict.  A refilled slot's request
    starts from zero state (K/V rows need no scrub: a slot never reads
    past its position).  ``mask`` names every slot; under ``mesh``, where
    this rank's states hold only its data slots, their entries of it are
    used."""
    for key in _STATE_KEYS:
        if key in cache:
            cache[key].masked_fill_(_slot_mask(mask, cache[key], mesh), 0)
    return cache


def _slot_mask(mask, leaf: torch.Tensor, mesh) -> torch.Tensor:
    """``mask`` (B,) bool over every slot as a mask that broadcasts over a
    state ``leaf`` (n_mamba, slots, ...), cut to this rank's data slots
    where the leaf holds only those."""
    m = (mask if torch.is_tensor(mask)
         else torch.from_numpy(np.asarray(mask, dtype=bool)))
    m = m.to(device=leaf.device, dtype=torch.bool)
    if leaf.shape[1] != m.shape[0]:
        m = m[sharding.local_slots(mesh, m.shape[0])]
    return m.view((1, -1) + (1,) * (leaf.dim() - 2))


def slot_state(cache: Dict[str, Any]) -> Dict[str, Any]:
    """A snapshot of every per-slot recurrent-state leaf (empty for a
    model without mamba layers).

    The reference holds the leaves themselves, which JAX never mutates;
    the port's steps update the states in place, so the snapshot is a
    copy of each.  Speculative verification takes one before it commits
    a window: attention rows past a rejection are hidden by the position
    mask, but a recurrent state has absorbed every row, so a rejected
    suffix is undone by :func:`restore_slot_state` and a replay of the
    accepted prefix.
    """
    return {key: cache[key].clone() for key in _STATE_KEYS if key in cache}


def restore_slot_state(cache: Dict[str, Any], state: Dict[str, Any], mask,
                       *, mesh=None) -> Dict[str, Any]:
    """Copy a :func:`slot_state` snapshot back into ``cache``'s state
    leaves, in place, for every slot where ``mask`` (B,) bool is set;
    other slots keep their state bit for bit.  Returns the same dict.
    Under ``mesh`` the leaves and the snapshot are this rank's, as in
    :func:`reset_paged_slots`."""
    for key, snap in state.items():
        leaf = cache[key]
        leaf.copy_(torch.where(_slot_mask(mask, leaf, mesh), snap, leaf))
    return cache


def _pool_keys(cfg: ModelConfig) -> Tuple[str, str]:
    """The cache's two pools of an attention layer: ``c``/``k_rope`` for
    MLA, else ``k``/``v``."""
    return ("c", "k_rope") if cfg.mla is not None else ("k", "v")


def _kv_scales(cache: Dict[str, Any], cfg: ModelConfig, kv_dtype: str,
               block_size: int) -> Tuple[Any, Any]:
    """The scale pools of ``cache``'s two attention pools (None, None
    without them, and for a model without attention layers), after
    checking that its pools have ``block_size`` rows a block and are
    stored as ``kv_dtype`` asks."""
    first, second = _pool_keys(cfg)
    if first not in cache:
        _pool_dtype(cfg, kv_dtype)
        return None, None
    pool = cache[first]
    if pool.shape[2] != block_size:
        raise ValueError(f"block_size {block_size} != the pools' "
                         f"{pool.shape[2]}")
    want = _pool_dtype(cfg, kv_dtype)
    if pool.dtype != want:
        raise ValueError(f"kv_dtype {kv_dtype!r} wants {want} pools, the "
                         f"cache holds {pool.dtype}")
    return cache.get(first + "_scale"), cache.get(second + "_scale")


def _layer(pool, i: int):
    return None if pool is None else pool[i]


def _ffn(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
         tp: Optional[layers.MeshContext]) -> torch.Tensor:
    """A layer's FFN on its normed input (B, S, d): the MoE FFN, each row
    of the chunk its own routing group, or the dense SwiGLU."""
    if "moe" in p:
        return moe.moe_ffn_rows(p["moe"], cfg, h, tp)
    return layers.swiglu(p["ffn"], h, tp)


def _mamba(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
           cache: Dict[str, Any], j: int,
           tp: Optional[layers.MeshContext],
           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mamba layer ``j``'s mixer on its normed input (B, S, d): the
    one-token recurrence, or with ``lengths`` the chunk form, from this
    rank's slots' states, which it writes back in place."""
    rows = slice(None) if tp is None else tp.state_rows
    s_pool, c_pool = cache["ssm_state"][j], cache["conv_state"][j]
    if lengths is None:
        y, s_new, c_new = ssm.mamba_decode(p, cfg, h, s_pool[rows],
                                           c_pool[rows], tp)
    else:
        y, s_new, c_new = ssm.mamba_chunk(p, cfg, h, s_pool[rows],
                                          c_pool[rows], lengths, tp)
    s_pool[rows] = s_new
    c_pool[rows] = c_new
    return y


def _mesh_context(mesh, cfg: ModelConfig, batch: int):
    return None if mesh is None else layers.MeshContext(mesh, cfg, batch)


def decode_step_paged(params: Dict[str, Any], cfg: ModelConfig,
                      tokens: torch.Tensor, cache: Dict[str, Any],
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      *, block_size: int, kv_dtype: str = "f32", mesh=None
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One continuous-batching serve step over the paged cache.

    tokens (B, 1); positions (B,) int32 per-slot cache lengths;
    block_tables (B, nb) int32 logical->physical block map; ``kv_dtype``
    the pools' storage dtype, as ``cache`` was made with.  Each slot
    commits its new token at ``positions[b]`` and attends over its own
    rows ``[0, positions[b]]``.  The pools in ``cache`` are updated in
    place and the same dict is returned.  Returns logits (B, 1,
    vocab_padded) fp32.  A mamba layer advances every slot's state by
    its token, idle slots included, as the reference's step does.  With
    ``mesh`` (every rank of it calls the step), ``params`` and ``cache``
    are this rank's shards and the logits are its slots'
    (``local_slots``).
    """
    ks, vs = _kv_scales(cache, cfg, kv_dtype, block_size)
    tp = _mesh_context(mesh, cfg, tokens.shape[0])
    own = slice(None) if tp is None else tp.slots
    x = layers.embed(params["embed"], tokens[own], tp).to(
        torch_dtype(cfg.compute_dtype))
    rows = (None if cfg.mla is None else mla.step_rows(
        positions, block_tables, torch.ones_like(positions), 1, block_size,
        own))
    _, norm_fn = layers.make_norm(cfg)
    for p, (kind, j) in zip(params["layers"], layer_pools(cfg)):
        h = norm_fn(p["norm1"], x)
        if "mla" in p:
            x = x + mla.mla_decode(
                p["mla"], cfg, h, cache["c"][j], cache["k_rope"][j],
                positions, block_tables, _layer(ks, j), _layer(vs, j), tp,
                rows,
            )
        elif kind == LayerKind.ATTN:
            x = x + attention.attention_decode_paged(
                p["attn"], cfg, h, cache["k"][j], cache["v"][j], positions,
                block_tables, _layer(ks, j), _layer(vs, j), tp,
            )
        else:
            x = x + _mamba(p["mamba"], cfg, h, cache, j, tp)
        if "norm2" in p:
            x = x + _ffn(p, cfg, norm_fn(p["norm2"], x), tp)
    return _lm_head(params, cfg, x, tp), cache


def _lm_head(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
             tp: Optional[layers.MeshContext] = None) -> torch.Tensor:
    """Final norm and LM head: (B, S, d) -> fp32 logits (B, S,
    vocab_padded).  Under ``tp`` a split head (column-parallel over the
    vocab, or the tied vocab-split embedding) gives this rank's vocab
    columns, gathered over ``model``."""
    _, norm_fn = layers.make_norm(cfg)
    x = norm_fn(params["final_norm"], x)
    split = tp is not None and (tp.vocab_split if cfg.tie_embeddings
                                else tp.head_split)
    if split:
        x = tp.copy(x)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.dense(params["lm_head"], x).float()
    return tp.mesh.gather(logits, "model", dim=-1) if split else logits


def prefill_step_paged(params: Dict[str, Any], cfg: ModelConfig,
                       tokens: torch.Tensor, cache: Dict[str, Any],
                       positions: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, block_size: int,
                       kv_dtype: str = "f32",
                       last_rows: Optional[torch.Tensor] = None, mesh=None
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Commit a chunk of up to ``w`` known tokens per slot in one call.

    tokens (B, w): slot ``b``'s next ``lengths[b]`` tokens, padded past
    them; positions (B,) int32 per-slot cache lengths before the chunk;
    block_tables (B, nb) int32, mapping every position a real row lands
    in; lengths (B,) int32 in [0, w]; ``kv_dtype`` the pools' storage
    dtype, as ``cache`` was made with.  Every layer projects all B*w rows
    at once: an attention layer attends with the chunked-prefill kernel
    (an MLA layer commits its latent rows and attends in torch ops),
    a mamba layer runs the chunk in the SSD dual form from each slot's
    state; rows past ``lengths[b]`` commit nothing and move no state, so a
    slot with ``lengths[b] == 0`` keeps its state.  The pools and states
    in ``cache`` are updated in place and the same dict is returned.

    Returns fp32 logits (B, w, vocab_padded), row ``c`` that of slot
    ``b``'s token ``c`` (rows past ``lengths[b]`` are finite and
    meaningless).  With ``last_rows`` (B,) only row ``last_rows[b]`` of
    each slot goes through the final norm and LM head, and the logits are
    (B, 1, vocab_padded): a serving step reads no other row.  With
    ``mesh``, as :func:`decode_step_paged`: this rank's shards, and its
    slots' logits (``last_rows`` holds every slot's).
    """
    ks, vs = _kv_scales(cache, cfg, kv_dtype, block_size)
    tp = _mesh_context(mesh, cfg, tokens.shape[0])
    own = slice(None) if tp is None else tp.slots
    x = layers.embed(params["embed"], tokens[own], tp).to(
        torch_dtype(cfg.compute_dtype))
    rows = (None if cfg.mla is None else mla.step_rows(
        positions, block_tables, lengths, tokens.shape[1], block_size, own))
    _, norm_fn = layers.make_norm(cfg)
    for p, (kind, j) in zip(params["layers"], layer_pools(cfg)):
        h = norm_fn(p["norm1"], x)
        if "mla" in p:
            x = x + mla.mla_chunk(
                p["mla"], cfg, h, cache["c"][j], cache["k_rope"][j],
                positions, block_tables, lengths, _layer(ks, j),
                _layer(vs, j), tp, rows,
            )
        elif kind == LayerKind.ATTN:
            x = x + attention.attention_prefill_paged(
                p["attn"], cfg, h, cache["k"][j], cache["v"][j], positions,
                block_tables, lengths, _layer(ks, j), _layer(vs, j), tp,
            )
        else:
            x = x + _mamba(p["mamba"], cfg, h, cache, j, tp, lengths[own])
        if "norm2" in p:
            x = x + _ffn(p, cfg, norm_fn(p["norm2"], x), tp)
    if last_rows is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, last_rows[own].long()][:, None]
    return _lm_head(params, cfg, x, tp), cache


# -- the dense path: teacher-forced forward, prefill, contiguous decode ------


#: remat policies of :func:`forward`, the reference's ``_remat``: none;
#: ``full`` recomputes each layer in the backward pass, saving only its
#: input; ``dots`` saves a layer's products with no batch dimension (the
#: 2-D matmuls, ``aten.mm``/``aten.addmm``, as the reference's
#: ``dots_with_no_batch_dims_saveable`` does) and recomputes the rest
REMAT_POLICIES = ("none", "full", "dots")

_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(fn, policy: str):
    """``fn`` wrapped by the remat ``policy``: a layer under
    ``torch.utils.checkpoint`` (non-reentrant), selective for ``dots``."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_DOTS))
    raise ValueError(f"unknown remat policy {policy!r}; have "
                     f"{REMAT_POLICIES}")


def _conv_tail(p_mamba: Dict[str, Any], cfg: ModelConfig,
               h: torch.Tensor) -> torch.Tensor:
    """The pre-activation conv window a decode takes over from a prefill:
    the last ``d_conv - 1`` pre-conv rows of ``h``, (B, d_conv - 1,
    conv_ch)."""
    return ssm._project_in(p_mamba, cfg, h[:, -(cfg.ssm.d_conv - 1):, :])[1]


def _apply_layer_full(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, collect_cache: bool,
                      tp: Optional[layers.MeshContext] = None):
    """One layer over a whole sequence x (B, S, d): (x, moe aux, and with
    ``collect_cache`` the layer's cache rows or final states).  Under a
    train step's ``tp``, on this rank's shards."""
    _, norm_fn = layers.make_norm(cfg)
    h = norm_fn(p["norm1"], x)
    cache = None
    if "mla" in p:
        if collect_cache:
            att, cache = mla.mla_full_with_cache(p["mla"], cfg, h, positions)
        else:
            att = mla.mla_full(p["mla"], cfg, h, positions, mesh=tp)
    elif "attn" in p:
        if collect_cache:
            att, cache = attention.attention_full_with_cache(
                p["attn"], cfg, h, positions)
        else:
            att = attention.attention_full(p["attn"], cfg, h, positions,
                                           mesh=tp)
    elif collect_cache:
        att, state = ssm.mamba_full(p["mamba"], cfg, h, return_state=True)
        cache = {"ssm_state": state,
                 "conv_state": _conv_tail(p["mamba"], cfg, h)}
    else:
        att = ssm.mamba_full(p["mamba"], cfg, h, mesh=tp)
    x = x + att
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        f, aux = moe.moe_ffn(p["moe"], cfg, norm_fn(p["norm2"], x), tp)
    elif "ffn" in p:
        f = layers.swiglu(p["ffn"], norm_fn(p["norm2"], x), tp)
    else:
        return x, aux, cache
    return x + f, aux, cache


def _run_full(params: Dict[str, Any], cfg: ModelConfig,
              tokens: torch.Tensor, collect_cache: bool, img_embeds=None,
              remat: str = "none", tp: Optional[layers.MeshContext] = None):
    """Every layer over tokens (B, S_text), after ``img_embeds`` (B,
    S_img, d) where given: (x (B, S, d) after the last layer, summed moe
    aux, and the layers' caches in layer order).  Each layer runs under
    the ``remat`` policy."""
    x = layers.embed(params["embed"], tokens, tp).to(
        torch_dtype(cfg.compute_dtype))
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(device=x.device, dtype=x.dtype), x],
                      dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)
    plan = mesh_ctx.current()

    def layer(p, x):  # a remat's recompute runs under the forward's plan
        with mesh_ctx.use_plan(plan):
            return _apply_layer_full(p, cfg, x, positions, collect_cache, tp)

    layer_fn = _remat(layer, remat)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for p in params["layers"]:
        x, aux, cache = layer_fn(p, x)
        aux_total = aux_total + aux
        caches.append(cache)
    return x, aux_total, caches


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            *, img_embeds=None, remat: str = "none", mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward.  tokens (B, S_text) -> (fp32 logits (B, S,
    vocab_padded), summed MoE load-balance aux).  With ``img_embeds`` (B,
    S_img, d) the sequence is [img, text] (the InternVL-style stub
    frontend) and S = S_img + S_text.  Every MoE layer routes all B * S
    tokens as one group, as the reference's does.  ``remat`` (one of
    :data:`REMAT_POLICIES`) trades the backward pass's memory for
    recomputation and leaves the values as they are.

    Under a train step's ``mesh`` (a
    :class:`~repro_torch.models.layers.MeshContext` with ``train=True``)
    the tokens are this data rank's rows and the parameters this rank's
    shards (:func:`~repro_torch.distributed.sharding.param_shardings`):
    the embedding and LM head are vocab-parallel where the rules split
    them, the logits are gathered over ``model`` (every vocab column on
    every rank), and an MoE layer routes in the layout of the active plan
    across the data ranks (:func:`~repro_torch.models.moe.moe_ffn`)."""
    x, aux, _ = _run_full(params, cfg, tokens, False, img_embeds, remat,
                          mesh)
    return _lm_head(params, cfg, x, mesh), aux


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *,
            mask: Optional[torch.Tensor] = None,
            real_vocab: Optional[int] = None,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy, the reference's ``lm_loss``.  logits (B,
    S, V) fp32; labels (B, S) integers, -1 to ignore.  ``real_vocab``
    masks the padded tail of the vocab with -1e30.  ``count`` divides the
    summed loss in place of the mask's own count (a data rank's share of
    the loss over the global batch's tokens).  The gold logit is
    rounded to bf16 and widened back, as the reference's bf16 one-hot
    contraction reads it (rounded after the gather, which rounds the same
    element without a bf16 copy of every logit)."""
    V = logits.shape[-1]
    if real_vocab is not None and real_vocab < V:
        pad = torch.arange(V, device=logits.device) >= real_vocab
        logits = logits.masked_fill(pad, -1e30)
    if mask is None:
        mask = labels >= 0
    labels_safe = labels.long().clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels_safe[..., None])[..., 0] \
        .to(torch.bfloat16).float()
    nll = (lse - gold) * mask
    if count is None:
        count = mask.sum()
    return nll.sum() / count.clamp_min(1)


def _stack_caches(caches: list) -> Dict[str, Any]:
    """The layers' cache rows (or states) as the dense cache's stacks,
    one a key over the layers that have it, in layer order."""
    out: Dict[str, list] = {}
    for cache in caches:
        for key, leaf in (cache or {}).items():
            out.setdefault(key, []).append(leaf)
    return {key: torch.stack(leaves) for key, leaves in out.items()}


def prefill(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            *, img_embeds=None, remat: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt tokens (B, S_text), after ``img_embeds`` where
    given, as :func:`forward` does: (fp32 logits of the last token (B, 1,
    vocab_padded), the dense cache of :func:`init_cache`'s layout holding
    the prompt's S rows, with ``pos`` S).  Mamba layers hand over their
    final state and their last ``d_conv - 1`` pre-conv rows."""
    x, _, caches = _run_full(params, cfg, tokens, True, img_embeds, remat)
    cache: Dict[str, Any] = {"pos": int(x.shape[1])}
    cache.update(_stack_caches(caches))
    return _lm_head(params, cfg, x[:, -1:]), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"
               ) -> Dict[str, Any]:
    """The dense (wave) cache: ``pos`` 0, a host int every slot shares,
    and zeroed contiguous caches in the compute dtype, one stack a kind
    over its layers in layer order: ``k``/``v`` (n_attn, batch, max_len,
    KV, D), or for MLA ``c`` (n_attn, batch, max_len, kv_lora_rank) and
    ``k_rope`` (n_attn, batch, max_len, qk_rope_dim); and for mamba layers
    ``ssm_state`` (n_mamba, batch, nh, d_state, head_dim) fp32 and
    ``conv_state`` (n_mamba, batch, d_conv - 1, conv_ch).  A stack with
    no layer is left out.  Layer ``j`` of a stack is a contiguous slice
    of it."""
    check_served(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.compute_dtype)
    n_attn = count_layers(cfg, LayerKind.ATTN)
    n_mamba = count_layers(cfg, LayerKind.MAMBA)
    cache: Dict[str, Any] = {"pos": 0}
    if n_attn:
        cache.update(
            mla.init_mla_cache(cfg, batch, max_len, dtype, n_attn, dev)
            if cfg.mla is not None else
            attention.init_cache(cfg, batch, max_len, dtype, n_attn, dev))
    if n_mamba:
        cache.update(ssm.init_mamba_cache(cfg, batch, dtype, n_mamba, dev))
    return cache


def decode_step(params: Dict[str, Any], cfg: ModelConfig,
                tokens: torch.Tensor, cache: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One wave step: tokens (B, 1) + the dense cache -> (fp32 logits (B,
    1, vocab_padded), the cache).

    Every slot sits at ``cache["pos"]``, a host int, so the step never
    waits on the device to read it; it makes the (B,) ``valid_len = pos +
    1`` once and every attention layer shares it.  Each attention layer
    writes its new K/V (or latent) row at ``pos`` and attends over rows
    ``[0, pos]``: a grouped-query layer through the contiguous
    flash-decode kernel, an MLA layer in the absorbed form in torch ops.
    A mamba layer advances every slot's state by its token.  An MoE layer
    routes the step's B tokens as one group.  The caches and states are
    updated in place (each state is replaced by a new tensor's values,
    never aliased), ``pos`` is advanced, and the same dict is returned.
    """
    pos = cache["pos"]
    first = "c" if cfg.mla is not None else "k"
    if first in cache and pos >= cache[first].shape[2]:
        raise ValueError(f"the cache holds {cache[first].shape[2]} rows; "
                         f"no room for a token at position {pos}")
    x = layers.embed(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    valid_len = attention.valid_lengths(pos, x.shape[0], x.device)
    _, norm_fn = layers.make_norm(cfg)
    for p, (kind, j) in zip(params["layers"], layer_pools(cfg)):
        h = norm_fn(p["norm1"], x)
        if "mla" in p:
            x = x + mla.mla_decode_dense(p["mla"], cfg, h, cache["c"][j],
                                         cache["k_rope"][j], pos, valid_len)
        elif kind == LayerKind.ATTN:
            x = x + attention.attention_decode(
                p["attn"], cfg, h, cache["k"][j], cache["v"][j], pos,
                valid_len)
        else:
            x = x + _mamba(p["mamba"], cfg, h, cache, j, None)
        if "norm2" in p:
            x = x + _ffn(p, cfg, norm_fn(p["norm2"], x), None)
    cache["pos"] = pos + 1
    return _lm_head(params, cfg, x), cache
