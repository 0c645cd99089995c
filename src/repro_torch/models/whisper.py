"""Whisper-style encoder-decoder backbone; the conv frontend is a stub.

Port of ``repro/models/whisper.py``.  Batches carry post-conv audio frames
(B, S_enc, d_model), S_enc = seq_len // 4, in place of the two stride-2
convs.  The encoder is a stack of non-causal self-attention blocks; the
decoder a causal transformer whose blocks also cross-attend to the
encoder's output.  Self-attention uses RoPE (the reference's documented
modernisation of Whisper's learned positions) and the config's QKV bias;
cross-attention is position-free and has no bias, as in the original.

The reference's ``enc_blocks``/``dec_blocks`` stacks (a ``lax.scan`` over
each) become two lists of per-layer parameter dicts, ``enc_layers`` and
``dec_layers``; :func:`params_from_numpy` carries the reference's tree
across.  Entry points, as the reference's: :func:`init_whisper`,
:func:`encode`, :func:`forward` (the teacher-forced train path, under a
remat policy), :func:`init_dec_cache`, :func:`prefill` and
:func:`decode_step`.

Decode: each decoder layer's self-attention commits its new K/V row into
its contiguous cache and attends over rows ``[0, pos]`` in one launch of
the contiguous flash-decode kernel
(:func:`~repro_torch.models.attention.attention_decode`), and its
cross-attention is a second launch of the same kernel over the layer's
cross K/V, every encoder row valid
(:func:`~repro_torch.kernels.flash_decode.flash_decode`; its plain version
for CPU tensors).  The reference computes that cross-attention with a
direct softmax whose probabilities are rounded to the value dtype before
the PV product; the kernel keeps them in fp32, which is exact in f32 and
a tolerated difference in bf16.  The reference's ``prefill`` cache holds
exactly the prompt's rows, so its next decode commit lands on the last of
them; :func:`prefill` with ``max_len`` places the rows into a cache of
``max_len`` rows instead, whose next row is free.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import attention, layers
from repro_torch.models.flash import flash_attention
from repro_torch.models.transformer import (REMAT_POLICIES, _lm_head,
                                            _map_tree, _remat, torch_dtype)

#: keys of the reference's parameter tree
_TREE_KEYS = {"embed", "enc_blocks", "dec_blocks", "enc_norm",
              "final_norm", "lm_head"}


def check_encoder_decoder(cfg: ModelConfig) -> None:
    if not cfg.is_encoder_decoder or cfg.enc_layers < 1:
        raise ValueError(f"{cfg.name}: not an encoder-decoder config")


def n_dec_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers - cfg.enc_layers


# -- parameters ---------------------------------------------------------------


def _init_cross_attn(gen, cfg, dtype, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": layers.dense_init(gen, d, h * hd, dtype, device),
        "wk": layers.dense_init(gen, d, kv * hd, dtype, device),
        "wv": layers.dense_init(gen, d, kv * hd, dtype, device),
        "wo": layers.dense_init(gen, h * hd, d, dtype, device),
    }


def init_whisper(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                 draw_device="cpu", place=None) -> Dict[str, Any]:
    """The port's own seeded init, laid out as
    :func:`~repro_torch.models.transformer.init_lm`'s (it does not
    reproduce the reference's numbers; :func:`params_from_numpy` carries
    those).  The numbers are drawn on ``draw_device``: on the CPU they do
    not depend on the device the model runs on; on the card they are
    other numbers of the same law, drawn in a fraction of the time.
    ``place`` sees each block as it is drawn, as ``init_lm``'s does."""
    check_encoder_decoder(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(resolve_device(draw_device)).manual_seed(seed)
    norm_init, _ = layers.make_norm(cfg)
    d, f = cfg.d_model, cfg.d_ff
    put = place or (lambda _, block: block)

    def block(path, names):
        """The layer at ``path``, its blocks drawn in ``names``' order."""
        draw = {"norm1": lambda: norm_init(dtype, dev),
                "attn": lambda: attention.init_attention(gen, cfg, dtype,
                                                         dev),
                "norm_x": lambda: norm_init(dtype, dev),
                "xattn": lambda: _init_cross_attn(gen, cfg, dtype, dev),
                "norm2": lambda: norm_init(dtype, dev),
                "ffn": lambda: layers.swiglu_init(gen, d, f, dtype, dev)}
        return {name: put(path + (name,), draw[name]()) for name in names}

    enc = ("norm1", "attn", "norm2", "ffn")
    dec = ("norm1", "attn", "norm_x", "xattn", "norm2", "ffn")
    return {
        "embed": put(("embed",), layers.embed_init(gen, cfg.vocab_padded, d,
                                                   dtype, dev)),
        "enc_layers": [block(("enc_layers", i), enc)
                       for i in range(cfg.enc_layers)],
        "dec_layers": [block(("dec_layers", i), dec)
                       for i in range(n_dec_layers(cfg))],
        "enc_norm": put(("enc_norm",), norm_init(dtype, dev)),
        "final_norm": put(("final_norm",), norm_init(dtype, dev)),
        "lm_head": put(("lm_head",), layers.dense_init(
            gen, d, cfg.vocab_padded, dtype, dev)),
    }


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda", *,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``np.asarray`` of every leaf of ``repro.models.whisper.init_whisper``)
    as the port's: row ``i`` of each stacked ``enc_blocks``/``dec_blocks``
    leaf becomes ``enc_layers[i]``/``dec_layers[i]``.  Leaves widen
    through float32, which is exact for bf16, and are copied.  With
    ``dtype`` every leaf takes that dtype (an optimizer state's moments or
    masters, gradients)."""
    check_encoder_decoder(cfg)
    if set(tree) != _TREE_KEYS:
        raise ValueError(f"not a parameter tree of {cfg.name}: keys "
                         f"{sorted(tree)}")
    dev = resolve_device(device)
    to = torch_dtype(cfg.param_dtype) if dtype is None else dtype

    def leaf(a) -> torch.Tensor:
        arr = np.array(a, dtype=np.float32, copy=True)
        return torch.from_numpy(arr).to(device=dev, dtype=to)

    def rows(stack: Mapping, n: int) -> list:
        return [_map_tree(stack, lambda a, i=i: leaf(np.asarray(a)[i]))
                for i in range(n)]

    params = {k: _map_tree(tree[k], leaf)
              for k in ("embed", "enc_norm", "final_norm", "lm_head")}
    params["enc_layers"] = rows(tree["enc_blocks"], cfg.enc_layers)
    params["dec_layers"] = rows(tree["dec_blocks"], n_dec_layers(cfg))
    return params


# -- the train path -----------------------------------------------------------


def _cross_kv(p: dict, cfg, enc_out: torch.Tensor,
              mesh: Optional[layers.MeshContext] = None):
    """A decoder layer's cross K and V over the encoder's output: (B, Se,
    KV, D) each; under a train step's ``mesh``, this rank's heads, or all
    of them gathered where a split cuts one."""
    B, Se, _ = enc_out.shape
    hd = cfg.head_dim
    mesh = attention.train_context(mesh)
    if mesh is not None:
        enc_out = mesh.copy(enc_out)
    k = layers.dense(p["wk"], enc_out)
    v = layers.dense(p["wv"], enc_out)
    if mesh is not None and not mesh.heads:
        k, v = (mesh.mesh.gather(t, "model", dim=-1) if split else t
                for t, split in zip((k, v), mesh.qkv_split[1:]))
    return k.reshape(B, Se, -1, hd), v.reshape(B, Se, -1, hd)


def _cross_attend(p: dict, cfg, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor,
                  mesh: Optional[layers.MeshContext] = None) -> torch.Tensor:
    """Position-free cross-attention of x (B, S, d) over k/v (B, Se, KV, D),
    no mask: (B, S, d); under a train step's ``mesh`` on the heads of
    :func:`_cross_kv`, ``wo`` row-parallel."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    mesh = attention.train_context(mesh)
    if mesh is not None:
        x = mesh.copy(x)
    q = layers.dense(p["wq"], x)
    if mesh is not None and not mesh.heads and mesh.qkv_split[0]:
        q = mesh.mesh.gather(q, "model", dim=-1)
    kv = k.shape[2]
    q = q.reshape(B, S, kv, -1, hd)
    out = flash_attention(q, k, v, causal=False)
    return attention._out_proj(p, out.reshape(B, S, -1), mesh)


def _policy(remat: str) -> str:
    """The reference checkpoints each whisper block whole under any remat
    other than none (its ``dots`` is ``full`` here)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; have "
                         f"{REMAT_POLICIES}")
    return "none" if remat == "none" else "full"


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None, :].expand(B, S)


def encode(params: Dict[str, Any], cfg: ModelConfig,
           enc_frames: torch.Tensor, *, remat: str = "none",
           mesh: Optional[layers.MeshContext] = None) -> torch.Tensor:
    """enc_frames (B, Se, d) -> the encoder's output (B, Se, d) in the
    compute dtype: non-causal self-attention with RoPE at positions 0..Se-1
    and a SwiGLU a block, then the encoder's norm.  Under a train step's
    ``mesh``, on this rank's shards."""
    x = enc_frames.to(torch_dtype(cfg.compute_dtype))
    B, Se, _ = x.shape
    positions = _positions(B, Se, x.device)
    _, norm_fn = layers.make_norm(cfg)

    def block(p, x):
        h = norm_fn(p["norm1"], x)
        x = x + attention.attention_full(p["attn"], cfg, h, positions,
                                         causal=False, mesh=mesh)
        return x + layers.swiglu(p["ffn"], norm_fn(p["norm2"], x), mesh)

    fn = _remat(block, _policy(remat))
    for p in params["enc_layers"]:
        x = fn(p, x)
    return norm_fn(params["enc_norm"], x)


def forward(params: Dict[str, Any], cfg: ModelConfig,
            enc_frames: torch.Tensor, tokens: torch.Tensor, *,
            remat: str = "none", mesh: Optional[layers.MeshContext] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: (fp32 logits (B, Sd, vocab_padded), an aux
    of 0).  ``remat`` other than none recomputes each block in the
    backward pass.  Under a train step's ``mesh`` (the rows of this data
    rank, this rank's shards), every projection by the reference's rules:
    heads over ``model`` for the self- and cross-attention, the SwiGLUs
    column then row-parallel, the embedding and LM head over the vocab,
    the logits gathered over ``model``."""
    enc_out = encode(params, cfg, enc_frames, remat=remat, mesh=mesh)
    x = layers.embed(params["embed"], tokens, mesh).to(
        torch_dtype(cfg.compute_dtype))
    B, Sd, _ = x.shape
    positions = _positions(B, Sd, x.device)
    _, norm_fn = layers.make_norm(cfg)

    def block(p, x, enc_out):
        h = norm_fn(p["norm1"], x)
        x = x + attention.attention_full(p["attn"], cfg, h, positions,
                                         causal=True, mesh=mesh)
        k, v = _cross_kv(p["xattn"], cfg, enc_out, mesh)
        x = x + _cross_attend(p["xattn"], cfg, norm_fn(p["norm_x"], x), k, v,
                              mesh)
        return x + layers.swiglu(p["ffn"], norm_fn(p["norm2"], x), mesh)

    fn = _remat(block, _policy(remat))
    for p in params["dec_layers"]:
        x = fn(p, x, enc_out)
    return (_lm_head(params, cfg, x, mesh),
            torch.zeros((), dtype=torch.float32, device=x.device))


# -- serving ------------------------------------------------------------------


def init_dec_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
                   device="cuda") -> Dict[str, Any]:
    """The decoder's cache: ``pos`` 0, a host int every slot shares, and
    zeroed contiguous stacks in the compute dtype over the decoder layers:
    self-attention ``k``/``v`` (n_dec, batch, max_len, KV, D) and
    ``cross_k``/``cross_v`` (n_dec, batch, enc_len, KV, D).  Layer ``j``
    of a stack is a contiguous slice of it."""
    check_encoder_decoder(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.compute_dtype)
    n, kv, hd = n_dec_layers(cfg), cfg.n_kv_heads, cfg.head_dim
    cache: Dict[str, Any] = {"pos": 0}
    for key, rows in (("k", max_len), ("v", max_len), ("cross_k", enc_len),
                      ("cross_v", enc_len)):
        cache[key] = torch.zeros((n, batch, rows, kv, hd), dtype=dtype,
                                 device=dev)
    return cache


def prefill(params: Dict[str, Any], cfg: ModelConfig,
            enc_frames: torch.Tensor, tokens: torch.Tensor, *,
            remat: str = "none", max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode the audio and consume the prompt tokens (B, Sd): (fp32
    logits of the last token (B, 1, vocab_padded), the decoder's cache
    with ``pos`` Sd).  The cache holds the prompt's Sd self-attention rows
    and every decoder layer's cross K/V, as the reference's does; with
    ``max_len`` it is an :func:`init_dec_cache` of ``max_len`` rows with
    the prompt's rows first, which :func:`decode_step` continues."""
    enc_out = encode(params, cfg, enc_frames, remat=remat)
    x = layers.embed(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    B, Sd, _ = x.shape
    if max_len is not None and max_len < Sd:
        raise ValueError(f"max_len {max_len} < the prompt's {Sd} rows")
    positions = _positions(B, Sd, x.device)
    _, norm_fn = layers.make_norm(cfg)
    rows: Dict[str, list] = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    for p in params["dec_layers"]:
        h = norm_fn(p["norm1"], x)
        att, kv_rows = attention.attention_full_with_cache(p["attn"], cfg, h,
                                                           positions)
        x = x + att
        h = norm_fn(p["norm_x"], x)
        ck, cv = _cross_kv(p["xattn"], cfg, enc_out)
        x = x + _cross_attend(p["xattn"], cfg, h, ck, cv)
        x = x + layers.swiglu(p["ffn"], norm_fn(p["norm2"], x))
        for key, leaf in (("k", kv_rows["k"]), ("v", kv_rows["v"]),
                          ("cross_k", ck), ("cross_v", cv)):
            rows[key].append(leaf)
    logits = _lm_head(params, cfg, x[:, -1:])
    if max_len is None:
        cache = {key: torch.stack(leaves) for key, leaves in rows.items()}
    else:
        cache = init_dec_cache(cfg, B, max_len, enc_out.shape[1], x.device)
        for key, leaves in rows.items():
            for j, leaf in enumerate(leaves):
                cache[key][j, :, :leaf.shape[1]] = leaf
    cache["pos"] = Sd
    return logits, cache


def cross_decode(p: dict, cfg, x: torch.Tensor, cross_k: torch.Tensor,
                 cross_v: torch.Tensor, enc_len: torch.Tensor
                 ) -> torch.Tensor:
    """One token's cross-attention: x (B, 1, d) over one layer's cross
    K/V (B, Se, KV, D), every row valid (``enc_len`` (B,) int32 holding
    Se), in one launch of the contiguous flash-decode kernel (its plain
    version for CPU tensors).  Returns (B, 1, d)."""
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = layers.dense(p["wq"], x).reshape(B, kv, h // kv, hd)
    out = flash_decode(q, cross_k, cross_v, enc_len,
                       block_s=cross_k.shape[1])
    return layers.dense(p["wo"], out.reshape(B, 1, h * hd))


def decode_step(params: Dict[str, Any], cfg: ModelConfig,
                tokens: torch.Tensor, cache: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder token a slot: tokens (B, 1) + the cache -> (fp32 logits
    (B, 1, vocab_padded), the cache).  Each decoder layer commits its new
    K/V row at ``pos`` and attends over rows ``[0, pos]`` (one launch of
    the contiguous flash-decode kernel), then cross-attends over its cross
    K/V (a second launch).  The caches are updated in place, ``pos`` is
    advanced, and the same dict is returned.  Raises when the cache has
    no row left."""
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} rows; no "
                         f"room for a token at position {pos}")
    x = layers.embed(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    B = x.shape[0]
    valid_len = attention.valid_lengths(pos, B, x.device)
    enc_len = torch.full((B,), cache["cross_k"].shape[2], dtype=torch.int32,
                         device=x.device)
    _, norm_fn = layers.make_norm(cfg)
    for j, p in enumerate(params["dec_layers"]):
        h = norm_fn(p["norm1"], x)
        x = x + attention.attention_decode(p["attn"], cfg, h, cache["k"][j],
                                           cache["v"][j], pos, valid_len)
        h = norm_fn(p["norm_x"], x)
        x = x + cross_decode(p["xattn"], cfg, h, cache["cross_k"][j],
                             cache["cross_v"][j], enc_len)
        x = x + layers.swiglu(p["ffn"], norm_fn(p["norm2"], x))
    cache["pos"] = pos + 1
    return _lm_head(params, cfg, x), cache
