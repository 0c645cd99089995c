"""Decoder-only LM core of the port: dense attention models, paged decode
and chunked prefill.

Port of the paged serving path of ``repro/models/transformer.py`` for
dense architectures (one attention layer per superblock, dense SwiGLU
FFN): ``init_lm``, ``init_paged_cache``, ``paged_block_bytes``,
``decode_step_paged`` and ``prefill_step_paged``.  The reference's
``lax.scan`` over stacked superblocks becomes a loop over a list of
per-layer parameter dicts, and the paged pools are updated in place
instead of being rebuilt, which saves a copy of the pool per step.  The
reference's ``prefill_step_paged`` scans its one-token cell over the
chunk; the port computes the chunk in parallel, every row of every slot
through each layer at once.  :func:`params_from_numpy` carries the
reference's parameters across.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention, layers

#: Physical block 0 is reserved as the NULL block: block tables of idle
#: serving slots point at it, so their writes land in rows no live request
#: reads.
NULL_BLOCK = 0


def check_dense(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is an architecture the port serves so far."""
    if (cfg.family != "dense" or cfg.layer_pattern != (LayerKind.ATTN,)
            or cfg.moe is not None or cfg.mla is not None
            or cfg.ssm is not None or cfg.is_encoder_decoder):
        raise ValueError(
            f"{cfg.name}: the port serves dense attention models only; "
            f"MoE, MLA, SSM and hybrid archs are ROADMAP item 1.10"
        )


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda"
            ) -> Dict[str, Any]:
    """The port's own seeded init (it does not reproduce the reference's
    numbers; use :func:`params_from_numpy` for those)."""
    check_dense(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator().manual_seed(seed)
    norm_init, _ = layers.make_norm(cfg)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype,
                                   dev),
        "final_norm": norm_init(dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                              cfg.vocab_padded, dtype, dev)
    params["layers"] = [
        {
            "norm1": norm_init(dtype, dev),
            "norm2": norm_init(dtype, dev),
            "attn": attention.init_attention(gen, cfg, dtype, dev),
            "ffn": layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, dev),
        }
        for _ in range(cfg.n_layers)
    ]
    return params


def _map_tree(tree: Mapping, fn) -> Dict[str, Any]:
    return {k: _map_tree(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda"
                      ) -> Dict[str, Any]:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``np.asarray`` of every leaf of ``repro.train.steps.init_model``) as
    the port's parameters.

    Leaves widen through float32, which is exact for bf16 (``np.asarray``
    of a bf16 JAX leaf is an ``ml_dtypes.bfloat16`` array, which
    ``torch.from_numpy`` rejects), and are copied, since such buffers are
    read-only.  The stacked superblock leaves ``blocks/slot0/...`` become
    one dict per layer.
    """
    check_dense(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def leaf(a) -> torch.Tensor:
        arr = np.array(a, dtype=np.float32, copy=True)
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    extra = set(tree) - {"embed", "final_norm", "lm_head", "blocks"}
    if extra or set(tree["blocks"]) != {"slot0"}:
        raise ValueError(f"not a dense parameter tree: keys {sorted(tree)}")
    params = {k: _map_tree(tree[k], leaf)
              for k in ("embed", "final_norm", "lm_head") if k in tree}
    stacked = tree["blocks"]["slot0"]
    params["layers"] = [
        _map_tree(stacked, lambda a, i=i: leaf(np.asarray(a)[i]))
        for i in range(cfg.n_superblocks)
    ]
    return params


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     block_size: int, device="cuda") -> Dict[str, Any]:
    """Zeroed paged K/V pools ``(n_layers, n_blocks, block_size, KV, D)``
    in the compute dtype, with ``n_blocks = 1 + slots * max_len /
    block_size``: every slot at full length plus the :data:`NULL_BLOCK`."""
    check_dense(cfg)
    if max_len % block_size:
        raise ValueError(f"max_len {max_len} not a multiple of block_size "
                         f"{block_size}")
    dev = resolve_device(device)
    n_blocks = 1 + slots * (max_len // block_size)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    dtype = torch_dtype(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def paged_block_bytes(cfg: ModelConfig, block_size: int) -> int:
    """Bytes one physical block stores across every attention layer."""
    itemsize = torch_dtype(cfg.compute_dtype).itemsize
    return (cfg.n_layers * block_size * 2 * cfg.n_kv_heads * cfg.head_dim
            * itemsize)


def _flat_index(positions: torch.Tensor, block_tables: torch.Tensor,
                block_size: int) -> torch.Tensor:
    """Pool row (B,) of each slot's new token: the block its position falls
    in, looked up in its table row, times the block size, plus the offset.
    Idle slots have all-zero table rows and so write into NULL_BLOCK."""
    pos = positions.long()
    nb = block_tables.shape[1]
    j = torch.clamp(pos // block_size, max=nb - 1)
    blk = block_tables.long().gather(1, j[:, None])[:, 0]
    return blk * block_size + pos % block_size


def decode_step_paged(params: Dict[str, Any], cfg: ModelConfig,
                      tokens: torch.Tensor, cache: Dict[str, Any],
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      *, block_size: int
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One continuous-batching serve step over the paged cache.

    tokens (B, 1); positions (B,) int32 per-slot cache lengths;
    block_tables (B, nb) int32 logical->physical block map.  Each slot
    commits its new token at ``positions[b]`` and attends over its own
    rows ``[0, positions[b]]``.  The pools in ``cache`` are updated in
    place and the same dict is returned.  Returns logits (B, 1,
    vocab_padded) fp32.
    """
    flat_idx = _flat_index(positions, block_tables, block_size)
    x = layers.embed(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    _, norm_fn = layers.make_norm(cfg)
    for i, p in enumerate(params["layers"]):
        h = norm_fn(p["norm1"], x)
        x = x + attention.attention_decode_paged(
            p["attn"], cfg, h, cache["k"][i], cache["v"][i], positions,
            block_tables, flat_idx,
        )
        x = x + layers.swiglu(p["ffn"], norm_fn(p["norm2"], x))
    return _lm_head(params, cfg, x), cache


def _lm_head(params: Dict[str, Any], cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head: (B, S, d) -> fp32 logits (B, S,
    vocab_padded)."""
    _, norm_fn = layers.make_norm(cfg)
    x = norm_fn(params["final_norm"], x)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    return layers.dense(params["lm_head"], x).float()


def prefill_step_paged(params: Dict[str, Any], cfg: ModelConfig,
                       tokens: torch.Tensor, cache: Dict[str, Any],
                       positions: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, block_size: int,
                       last_rows: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Commit a chunk of up to ``w`` known tokens per slot in one call.

    tokens (B, w): slot ``b``'s next ``lengths[b]`` tokens, padded past
    them; positions (B,) int32 per-slot cache lengths before the chunk;
    block_tables (B, nb) int32, mapping every position a real row lands
    in; lengths (B,) int32 in [0, w].  Every layer projects all B*w rows
    at once and attends with the chunked-prefill kernel; rows past
    ``lengths[b]`` commit nothing.  The pools in ``cache`` are updated in
    place and the same dict is returned.

    Returns fp32 logits (B, w, vocab_padded), row ``c`` that of slot
    ``b``'s token ``c`` (rows past ``lengths[b]`` are finite and
    meaningless).  With ``last_rows`` (B,) only row ``last_rows[b]`` of
    each slot goes through the final norm and LM head, and the logits are
    (B, 1, vocab_padded): a serving step reads no other row.
    """
    if cache["k"].shape[2] != block_size:
        raise ValueError(f"block_size {block_size} != the pools' "
                         f"{cache['k'].shape[2]}")
    x = layers.embed(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    _, norm_fn = layers.make_norm(cfg)
    for i, p in enumerate(params["layers"]):
        h = norm_fn(p["norm1"], x)
        x = x + attention.attention_prefill_paged(
            p["attn"], cfg, h, cache["k"][i], cache["v"][i], positions,
            block_tables, lengths,
        )
        x = x + layers.swiglu(p["ffn"], norm_fn(p["norm2"], x))
    if last_rows is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, last_rows.long()][:, None]
    return _lm_head(params, cfg, x), cache
