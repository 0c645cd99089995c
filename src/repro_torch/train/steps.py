"""Step functions: the train step, and the prefill and decode steps, for
every family.

Port of ``repro/train/steps.py``.  ``make_train_step(cfg, run)`` closes
over the model (a dense, MoE, SSM or hybrid LM, the VLM stub, or the
encoder-decoder, :mod:`repro_torch.models.whisper`) and the run options
(remat policy, microbatching, MoE aux weight) and returns ``(params,
opt_state, batch) -> (params, opt_state, metrics)``, with ``batch`` a
dict of tensors (``tokens``, ``labels``, for the VLM ``img_embeds`` and
for the encoder-decoder ``enc_frames``).  The step is functional, as the
reference's is: the caller's trees stay valid.  ``donate=True``, the
counterpart of ``jax.jit(..., donate_argnums=(0, 1))``, updates params and
optimizer state in place instead, so a step holds one copy of them.

Gradient accumulation: with ``run.microbatches > 1`` the batch is split on
its leading axis and ``grad.float() / n`` is summed over the microbatches,
then cast to each param's dtype, as the reference's ``lax.scan`` does.

On a (data, model) mesh of ranks, ``make_train_step(cfg, run, mesh,
shapes=...)`` is the reference's step under its host mesh: each rank runs
the model on its data rank's rows (:func:`repro_torch.data.pipeline.rank_rows`)
and its shards of the parameters, the token-mean loss divides by the
global token count, the gradients are summed over ``data`` (an all-reduce,
or under ``run.zero`` a reduce-scatter) and AdamW updates this rank's
shards (:class:`~repro_torch.optim.adamw.ShardLayout`).  ``loss`` is
summed and ``moe_aux`` is whole on every data rank, so every rank reports
the global metrics.  ``zero`` places the optimizer state and never
changes a value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import TrainView
from repro_torch.models import layers, transformer, whisper
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The reference's run options.  ``zero`` shards the optimizer state
    over the data axis of a train mesh (ZeRO); one device ignores it."""
    remat: str = "dots"  # none | dots | full
    microbatches: int = 1
    moe_aux_weight: float = 0.01
    zero: bool = True
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


BASELINE_RUN = RunConfig(remat="full", microbatches=1, zero=False)
OPTIMIZED_RUN = RunConfig(remat="full", microbatches=1, zero=True)


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda",
               draw_device="cpu", place=None) -> Dict[str, Any]:
    """The port's seeded init of ``cfg``'s parameters
    (:func:`repro_torch.models.whisper.init_whisper` for an
    encoder-decoder, else :func:`repro_torch.models.transformer.init_lm`);
    ``place(path, block)`` sees each block of leaves as it is drawn."""
    init = whisper.init_whisper if cfg.is_encoder_decoder \
        else transformer.init_lm
    return init(cfg, seed=seed, device=device, draw_device=draw_device,
                place=place)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def param_shapes(cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """``cfg``'s parameter tree as meta tensors (shapes and dtypes), drawn
    on ``device`` a block at a time, so that it never holds more than one
    block."""
    return init_model(cfg, device=device, draw_device=device,
                      place=lambda _, block: tree_map(_meta, block))


def init_shards(cfg: ModelConfig, layout: adamw.ShardLayout,
                opt: adamw.AdamWConfig, *, seed: int = 0, device="cuda"
                ) -> Dict[str, Any]:
    """{"params", "opt"} of this rank of ``layout``'s mesh: the seeded
    init drawn on ``device`` (the bits a one-device run on it draws), each
    block cut to this rank's blocks of its leaves before the next is
    drawn, so a rank never holds the whole model; the optimizer state
    made from those blocks."""
    dev = torch.device(device)
    params = init_model(cfg, seed=seed, device=dev, draw_device=dev,
                        place=lambda path, block: layout.cut_block(
                            path, block, dev))
    return {"params": params, "opt": layout.init_state(params, opt, dev)}


def params_from_numpy(tree, cfg: ModelConfig, device="cuda", **kw
                      ) -> Dict[str, Any]:
    """The reference's parameter tree of ``cfg`` (or a tree of its shape,
    with ``dtype=``) as the port's, by the family's layout map."""
    convert = whisper.params_from_numpy if cfg.is_encoder_decoder \
        else transformer.params_from_numpy
    return convert(tree, cfg, device, **kw)


def model_forward(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                  remat: str, mesh: Optional[layers.MeshContext] = None):
    """(logits, aux, labels) aligned per family: with ``img_embeds`` in
    the batch the image positions, which carry no labels, are cut from
    the logits.  Under a train step's ``mesh``, on this rank's rows and
    shards."""
    if cfg.is_encoder_decoder:
        logits, aux = whisper.forward(params, cfg, batch["enc_frames"],
                                      batch["tokens"], remat=remat,
                                      mesh=mesh)
        return logits, aux, batch.get("labels")
    img = batch.get("img_embeds")
    logits, aux = transformer.forward(params, cfg, batch["tokens"],
                                      img_embeds=img, remat=remat, mesh=mesh)
    if img is not None:
        logits = logits[:, img.shape[1]:, :]
    return logits, aux, batch.get("labels")


def loss_fn(params, cfg: ModelConfig, batch, run: RunConfig,
            mesh: Optional[layers.MeshContext] = None):
    """(loss + moe_aux_weight * aux, {"loss", "moe_aux"}).  Under a train
    step's ``mesh``, this data rank's share: its tokens' summed loss over
    the global token count (so that the shares and their gradients sum
    over ``data`` to the global ones) plus the whole aux, whose gradient
    reaches only this rank's tokens."""
    logits, aux, labels = model_forward(params, cfg, batch, remat=run.remat,
                                        mesh=mesh)
    count = None
    if mesh is not None:
        count = mesh.mesh.base.sum((labels >= 0).sum().float(), "data")
    loss = transformer.lm_loss(logits, labels, real_vocab=cfg.vocab,
                               count=count)
    total = loss + run.moe_aux_weight * aux
    return total, {"loss": loss, "moe_aux": aux}


def loss_and_grads(params, cfg: ModelConfig, batch, run: RunConfig,
                   mesh: Optional[layers.MeshContext] = None
                   ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(gradient tree of ``params``' structure, each leaf in its param's
    dtype, detached metrics of :func:`loss_fn`): the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  ``params`` is left as
    it was."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, metrics = loss_fn(live, cfg, batch, run, mesh)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return (tree_map(lambda _: next(it), params),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, run: RunConfig, mesh=None, *,
                    shapes: Any = None, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics ``loss``, ``moe_aux``, ``grad_norm`` and ``lr``
    are 0-d tensors.  With ``donate`` the given params and state are
    updated in place and returned.

    With ``mesh`` (a rank's mesh of :func:`~repro_torch.launch.mesh.
    make_train_mesh`) every rank of it calls the step with its blocks of
    the parameters, its shards of the state and its data rank's rows of
    the batch; ``shapes`` is a tree of the full parameters (anything with
    ``.shape``), from which the step's
    :class:`~repro_torch.optim.adamw.ShardLayout` (``step.layout``)
    places them."""
    layout = view = None
    if mesh is not None:
        if shapes is None:
            raise ValueError("a train step on a mesh needs the full "
                             "parameters' shapes")
        layout = adamw.ShardLayout(shapes, mesh, zero=run.zero)
        view = TrainView(mesh)

    def grads_of(params, batch):
        tp = None
        if view is not None:
            rows = next(iter(batch.values())).shape[0]
            tp = layers.MeshContext(view, cfg, rows, train=True)
        return loss_and_grads(params, cfg, batch, run, tp)

    def accumulated(params, batch):
        n = run.microbatches

        def resplit(x):
            b = x.shape[0]
            if b % n:
                raise ValueError(f"batch {b} % microbatches {n}")
            return x.reshape(n, b // n, *x.shape[1:])

        mbs = {k: resplit(v) for k, v in batch.items()}
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        macc = {}
        for i in range(n):
            grads, metrics = grads_of(params, {k: v[i]
                                               for k, v in mbs.items()})
            tree_map(lambda a, g: a.add_(g.float() / n), gacc, grads)
            del grads
            macc = {k: macc.get(k, 0) + m / n for k, m in metrics.items()}
        return tree_map(lambda g, p: g.to(p.dtype), gacc, params), macc

    def train_step(params, opt_state, batch):
        if run.microbatches > 1:
            grads, metrics = accumulated(params, batch)
        else:
            grads, metrics = grads_of(params, batch)
        if layout is not None:  # each leaf freed once it is sent
            holder = [grads]
            del grads
            grads = layout.reduce_grads(holder)
            metrics["loss"] = mesh.sum(metrics["loss"], "data")
        params, opt_state, stats = adamw.apply_update(
            params, grads, opt_state, run.opt, inplace=donate,
            layout=layout)
        metrics = dict(metrics)
        metrics.update(stats)
        return params, opt_state, metrics

    train_step.layout = layout
    return train_step


# -- serving ------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, run: RunConfig = OPTIMIZED_RUN):
    """``prefill_step(params, *, tokens, img_embeds=None)``: the dense
    :func:`~repro_torch.models.transformer.prefill`; for an
    encoder-decoder ``prefill_step(params, *, enc_frames, tokens,
    max_len=None)``, :func:`~repro_torch.models.whisper.prefill`.  Without
    autograd."""
    if cfg.is_encoder_decoder:

        @torch.no_grad()
        def prefill_step(params, *, enc_frames, tokens, max_len=None):
            return whisper.prefill(params, cfg, enc_frames, tokens,
                                   remat=run.remat, max_len=max_len)

        return prefill_step

    @torch.no_grad()
    def prefill_step(params, *, tokens, img_embeds=None):
        return transformer.prefill(params, cfg, tokens,
                                   img_embeds=img_embeds, remat=run.remat)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_fn(params, *, tokens, cache)``: the dense
    :func:`~repro_torch.models.transformer.decode_step`, or for an
    encoder-decoder :func:`~repro_torch.models.whisper.decode_step`,
    without autograd."""
    step = whisper.decode_step if cfg.is_encoder_decoder \
        else transformer.decode_step

    @torch.no_grad()
    def decode_fn(params, *, tokens, cache):
        return step(params, cfg, tokens, cache)

    return decode_fn
