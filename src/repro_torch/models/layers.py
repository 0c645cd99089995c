"""Shared layers: dense, norms, rotary embeddings, SwiGLU, embeddings.

Port of ``repro/models/layers.py``.  Parameters are plain dictionaries of
tensors with the reference's names and layouts (a dense weight is
``(d_in, d_out)``), so the reference's parameter tree maps onto them leaf
by leaf.  Norm math runs in fp32 whatever the compute dtype and is cast
back.

Tensor parallelism: a :class:`MeshContext` carries one serve or train
step's view of a mesh of ranks, and the layers it is passed to run on this
rank's shards of the parameters (:mod:`repro_torch.distributed.sharding`):
row-parallel products are summed over ``model`` in fp32 and take their
bias once after the sum, the embedding looks up only this rank's vocab
rows and sums over ``model`` (exact: one term is nonzero), and every rule
that does not divide leaves its weights whole.  A train step's context
(``train=True``) runs over a
:class:`~repro_torch.distributed.tensor_parallel.TrainView` of the mesh,
whose sums and gathers carry gradients, and its :meth:`MeshContext.copy`
marks where a whole tensor enters split work (Megatron's ``f``): the
column-parallel inputs, and the replicated vectors a rank reads only its
heads of.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel


def truncated_normal(gen: torch.Generator, shape, scale: float, dtype,
                     device) -> torch.Tensor:
    """Fan-in scaled normal, clipped at two standard deviations; drawn in
    fp32 from ``gen`` on its device (a CPU generator gives numbers that do
    not depend on the device they are used on) and then cast and
    moved."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / max(1.0, fan_in ** 0.5)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.clamp_(-2.0, 2.0).mul_(std).to(device=device, dtype=dtype)


def _seeded_draws(gen: torch.Generator, n: int, draw: Callable) -> list:
    """``draw(i, g)`` for i < n, each with a generator ``g`` of its own on
    ``gen``'s device, seeded by the i-th of n seeds drawn from ``gen``, in
    parallel threads (one CPU draw stream is single-threaded, and an
    expert stack holds hundreds of millions of numbers).  The numbers do
    not depend on the thread count."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                          device=gen.device).tolist()
    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as pool:
        return list(pool.map(
            lambda i: draw(i, torch.Generator(gen.device).manual_seed(
                seeds[i])), range(n)))


def truncated_normal_stack(gen: torch.Generator, shape, scale: float, dtype,
                           device) -> torch.Tensor:
    """:func:`truncated_normal`'s law for a stack of matrices ``(n, d_in,
    d_out)``, matrix i drawn by :func:`_seeded_draws` straight into its
    place in the stack."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    _seeded_draws(gen, shape[0], lambda i, g: out[i].copy_(truncated_normal(
        g, shape[1:], scale, torch.float32, gen.device)))
    return out.to(device)


def truncated_normal_many(gen: torch.Generator, shapes, scale: float, dtype,
                          device) -> list:
    """:func:`truncated_normal`'s law for several matrices, matrix i drawn
    by :func:`_seeded_draws`."""
    out = _seeded_draws(gen, len(shapes), lambda i, g: truncated_normal(
        g, shapes[i], scale, dtype, gen.device))
    return [t.to(device) for t in out]


def dense_init(gen, d_in: int, d_out: int, dtype, device, *,
               bias: bool = False) -> dict:
    p = {"w": truncated_normal(gen, (d_in, d_out), 1.0, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def row_parallel(y: torch.Tensor, mesh, bias=None) -> torch.Tensor:
    """The sum over ``model`` of this rank's partial product ``y`` of a
    row-parallel projection: added in fp32 and cast back to
    ``y``'s dtype, then ``bias`` (whole on every rank) added once."""
    out = mesh.sum(y.float(), "model").to(y.dtype)
    return out if bias is None else out + bias.to(y.dtype)


class MeshContext:
    """One serve step over a mesh of ranks: which slots this rank computes
    and which of the model's weights its shards split.

    ``slots`` is this rank's block of the step's ``batch`` slots
    (:func:`sharding.local_slots`); ``split_slots`` says whether that is
    not all of them.  The ``*_split`` flags follow the reference's rules on
    the full shapes: a flag is set where the rule splits a weight over a
    ``model`` axis of more than one rank.  ``heads`` says whether the K/V
    pools split their heads (``paged_cache_spec``), so that attention runs
    on this rank's heads; it holds on a model axis of one rank too.
    ``experts_split`` and ``shared_split`` say whether an MoE layer's
    expert stacks split their experts (expert parallelism) and its shared
    experts their columns; ``batch`` is the step's full slot count, from
    which MoE capacity is counted.

    ``mla_split`` says whether an MLA layer's ``wq``, ``w_uk`` and ``w_uv``
    split their heads over ``model`` and its ``wo`` is row-parallel;
    ``w_dkv``, ``kv_norm`` and the latent pools stay whole (``heads`` is
    False for an MLA model, which has no K/V pools).

    ``mamba_split`` says whether the mamba mixers split over ``model``:
    ``wz``/``wx``/``wdt`` and ``conv_x_*`` over heads and channels,
    ``out_proj`` row-parallel, and the recurrent states over heads and
    channels (``paged_cache_spec``).  The rules split all of these or none
    on the configs the port serves; a model axis that would split only
    some is refused.  ``state_rows`` indexes this rank's slots in the
    slot axis of its states: all of its rows where the states split their
    slots over ``data``, else the rows of ``slots``.

    With ``train=True`` the context is a train step's over ``mesh``, a
    :class:`~repro_torch.distributed.tensor_parallel.TrainView`: ``batch``
    is this data rank's rows, all of which it computes; ``heads`` says
    whether ``wq``, ``wk`` and ``wv`` all split on whole heads (then
    attention runs on this rank's heads; where a split cuts a head, q, k
    and v are gathered over ``model``); the mamba flags read the train
    rules, which split the mixers on every mesh shape.
    """

    def __init__(self, mesh, cfg, batch: int, *, train: bool = False):
        self.mesh = mesh
        self.batch = batch
        self.train = train
        self.slots = (slice(0, batch) if train
                      else sharding.local_slots(mesh, batch))
        self.split_slots = self.slots.stop - self.slots.start < batch
        d, hd, vp = cfg.d_model, cfg.head_dim, cfg.vocab_padded
        h, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        n_model = mesh.axis_size("model")
        many = n_model > 1

        def split(path, shape) -> bool:
            return many and "model" in sharding.spec_for_path(path, shape,
                                                              mesh)

        # an MLA model has no K/V pools: its latent pools are whole
        self.heads = cfg.mla is None and "model" in (
            sharding.paged_cache_spec("k", (1, 1, cfg.n_kv_heads, hd), mesh))
        self.qkv_split = (split("attn/wq/w", (d, h)),
                          split("attn/wk/w", (d, kv)),
                          split("attn/wv/w", (d, kv)))
        self.wo_split = split("attn/wo/w", (h, d))
        # the rules split wi_gate, wi_up and wo on d_ff alike
        self.ffn_split = split("ffn/wo", (cfg.d_ff, d))
        self.vocab_split = split("embed/embedding", (vp, d))
        self.head_split = (not cfg.tie_embeddings
                           and split("lm_head/w", (d, vp)))
        m = cfg.moe
        self.experts_split = m is not None and split(
            "moe/wi_gate", (m.n_routed, d, m.d_ff_expert))
        self.shared_split = m is not None and m.n_shared > 0 and split(
            "moe/shared/wo", (m.n_shared * m.d_ff_expert, d))
        if train:
            self.heads = (all(self.qkv_split) and cfg.n_heads % n_model == 0
                          and cfg.n_kv_heads % n_model == 0)
        self.mla_split = False
        if cfg.mla is not None:
            self.mla_split = self._mla_split(cfg, split, mesh)
        self.mamba_split, self.state_rows = False, self.slots
        s = cfg.ssm
        if s is None:
            return
        di, nh = s.d_inner(d), s.n_heads(d)
        state = (1, batch, nh, s.d_state, s.head_dim)
        conv = (1, batch, s.d_conv - 1, di + 2 * s.n_groups * s.d_state)
        rule = sharding.spec_for_path if train else sharding.serve_spec

        def mixer(path, shape) -> bool:
            return many and "model" in rule("mamba/" + path, shape, mesh)

        flags = (mixer("wz/w", (d, di)), mixer("wx/w", (d, di)),
                 mixer("wdt/w", (d, nh)), mixer("conv_x_w", (s.d_conv, di)),
                 mixer("out_proj/w", (di, d)))
        if not train:  # the serve path's states split with the weights
            flags += ("model" in sharding.paged_cache_spec(
                "ssm_state", state, mesh), "model" in
                sharding.paged_cache_spec("conv_state", conv, mesh))
        if any(flags) and not all(flags):
            raise ValueError(
                f"{cfg.name}: a model axis of {mesh.axis_size('model')} "
                f"splits some of the mamba mixer's weights and states and "
                f"not others; serve it on a model axis that divides "
                f"d_inner, the SSM heads and the conv channels")
        self.mamba_split = all(flags)
        if not train and sharding.paged_cache_spec(
                "ssm_state", state, mesh)[1] is not None:
            self.state_rows = slice(None)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a tensor every rank of ``model`` holds whole, as it
        enters work split over ``model``: in a train step its gradient is
        summed over ``model`` (Megatron's ``f``); serving needs nothing."""
        if not self.train:
            return x
        return tensor_parallel.copy_to(x, self.mesh.base, "model")

    def own(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's ``1/M`` block of ``dim`` of ``x``, a tensor every
        rank of ``model`` holds whole; in a train step its gradient's
        blocks are gathered back."""
        if self.train:
            return tensor_parallel.split_to(x, self.mesh.base, "model", dim)
        per = x.shape[dim] // self.mesh.axis_size("model")
        return x.narrow(dim, self.mesh.axis_index("model") * per, per)

    @staticmethod
    def _mla_split(cfg, split, mesh) -> bool:
        """Whether the rules split ``wq``, ``w_uk``, ``w_uv`` (columns) and
        ``wo`` (rows) over ``model``, each on whole heads; a model axis that
        would split only some of them, or cut a head, is refused."""
        ml, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        qd = ml.qk_nope_dim + ml.qk_rope_dim
        flags = (split("mla/wq/w", (d, h * qd)),
                 split("mla/w_uk/w", (ml.kv_lora_rank, h * ml.qk_nope_dim)),
                 split("mla/w_uv/w", (ml.kv_lora_rank, h * ml.v_head_dim)),
                 split("mla/wo/w", (h * ml.v_head_dim, d)))
        if any(flags) and not (all(flags)
                               and h % mesh.axis_size("model") == 0):
            raise ValueError(
                f"{cfg.name}: a model axis of {mesh.axis_size('model')} "
                f"splits some of the MLA projections and not others, or "
                f"cuts a head; serve it on a model axis that divides the "
                f"{h} heads")
        return all(flags)


# --- norms -------------------------------------------------------------------


def rms_norm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if params is not None and "scale" in params:
        y = y * params["scale"].float()
    return y.to(x.dtype)


def layer_norm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the population variance; with empty params this is
    OLMo's non-parametric LN."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if params and "scale" in params:
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def make_norm(cfg) -> Tuple[Callable, Callable]:
    """Returns (init_fn(dtype, device) -> params, apply_fn(params, x) -> x)
    for the config's norm."""
    if cfg.nonparam_ln:
        return ((lambda dtype, device: {}),
                (lambda p, x: layer_norm({}, x, cfg.norm_eps)))
    if cfg.rms_norm:
        return ((lambda dtype, device: rms_norm_init(cfg.d_model, dtype,
                                                     device)),
                (lambda p, x: rms_norm(p, x, cfg.norm_eps)))
    return ((lambda dtype, device: layer_norm_init(cfg.d_model, dtype,
                                                   device)),
            (lambda p, x: layer_norm(p, x, cfg.norm_eps)))


# --- rotary ------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for the given positions: (..., dim//2), fp32."""
    half = dim // 2
    exponents = torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = 1.0 / (theta ** exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2).  Split-half
    convention: the first and second halves of D form the pairs."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    if cos.dim() == 2:  # (S, D/2) -> broadcast over batch and heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, D/2)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- FFN and embeddings ------------------------------------------------------


def swiglu_init(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    """Gate, up and down matrices, each drawn from a generator of its own
    (:func:`truncated_normal_many`)."""
    gate, up, down = truncated_normal_many(
        gen, ((d_model, d_ff), (d_model, d_ff), (d_ff, d_model)), 1.0,
        dtype, device)
    return {"wi_gate": gate, "wi_up": up, "wo": down}


def swiglu(params: dict, x: torch.Tensor,
           mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """SwiGLU FFN; with ``mesh`` and split weights, gate and up are
    column-parallel and the down projection row-parallel."""
    if mesh is not None and mesh.ffn_split:
        x = mesh.copy(x)
    g = x @ params["wi_gate"].to(x.dtype)
    u = x @ params["wi_up"].to(x.dtype)
    y = (F.silu(g) * u) @ params["wo"].to(x.dtype)
    if mesh is not None and mesh.ffn_split:
        return row_parallel(y, mesh.mesh)
    return y


def embed_init(gen, vocab: int, d_model: int, dtype, device) -> dict:
    return {"embedding": truncated_normal(gen, (vocab, d_model), 1.0, dtype,
                                          device)}


def embed(params: dict, tokens: torch.Tensor,
          mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Embedding lookup; with ``mesh`` and a vocab-split table, each rank
    looks up the tokens in its rows, a zero row for the others, and the
    rows are summed over ``model``."""
    table = params["embedding"]
    if mesh is None or not mesh.vocab_split:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - mesh.mesh.axis_index("model") * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0)
    return mesh.mesh.sum(x, "model")


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits: the matmul runs in x's dtype, the logits
    come out fp32."""
    return (x @ params["embedding"].to(x.dtype).T).float()
