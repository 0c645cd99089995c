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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer, whisper
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The reference's run options on one device.  Its ``zero`` (ZeRO
    sharding of the optimizer state over data axes) comes with the train
    mesh, ROADMAP item 1.18.2, and with it ``BASELINE_RUN``, which differs
    from :data:`OPTIMIZED_RUN` only there."""
    remat: str = "dots"  # none | dots | full
    microbatches: int = 1
    moe_aux_weight: float = 0.01
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


OPTIMIZED_RUN = RunConfig(remat="full", microbatches=1)


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda",
               draw_device="cpu") -> Dict[str, Any]:
    """The port's seeded init of ``cfg``'s parameters
    (:func:`repro_torch.models.whisper.init_whisper` for an
    encoder-decoder, else :func:`repro_torch.models.transformer.init_lm`)."""
    init = whisper.init_whisper if cfg.is_encoder_decoder \
        else transformer.init_lm
    return init(cfg, seed=seed, device=device, draw_device=draw_device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda", **kw
                      ) -> Dict[str, Any]:
    """The reference's parameter tree of ``cfg`` (or a tree of its shape,
    with ``dtype=``) as the port's, by the family's layout map."""
    convert = whisper.params_from_numpy if cfg.is_encoder_decoder \
        else transformer.params_from_numpy
    return convert(tree, cfg, device, **kw)


def model_forward(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                  remat: str):
    """(logits, aux, labels) aligned per family: with ``img_embeds`` in
    the batch the image positions, which carry no labels, are cut from
    the logits."""
    if cfg.is_encoder_decoder:
        logits, aux = whisper.forward(params, cfg, batch["enc_frames"],
                                      batch["tokens"], remat=remat)
        return logits, aux, batch.get("labels")
    img = batch.get("img_embeds")
    logits, aux = transformer.forward(params, cfg, batch["tokens"],
                                      img_embeds=img, remat=remat)
    if img is not None:
        logits = logits[:, img.shape[1]:, :]
    return logits, aux, batch.get("labels")


def loss_fn(params, cfg: ModelConfig, batch, run: RunConfig):
    """(loss + moe_aux_weight * aux, {"loss", "moe_aux"})."""
    logits, aux, labels = model_forward(params, cfg, batch, remat=run.remat)
    loss = transformer.lm_loss(logits, labels, real_vocab=cfg.vocab)
    total = loss + run.moe_aux_weight * aux
    return total, {"loss": loss, "moe_aux": aux}


def loss_and_grads(params, cfg: ModelConfig, batch, run: RunConfig
                   ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(gradient tree of ``params``' structure, each leaf in its param's
    dtype, detached metrics of :func:`loss_fn`): the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  ``params`` is left as
    it was."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, metrics = loss_fn(live, cfg, batch, run)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return (tree_map(lambda _: next(it), params),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, run: RunConfig, *,
                    donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics ``loss``, ``moe_aux``, ``grad_norm`` and ``lr``
    are 0-d tensors.  With ``donate`` the given params and state are
    updated in place and returned."""

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
            grads, metrics = loss_and_grads(
                params, cfg, {k: v[i] for k, v in mbs.items()}, run)
            tree_map(lambda a, g: a.add_(g.float() / n), gacc, grads)
            del grads
            macc = {k: macc.get(k, 0) + m / n for k, m in metrics.items()}
        return tree_map(lambda g, p: g.to(p.dtype), gacc, params), macc

    def train_step(params, opt_state, batch):
        if run.microbatches > 1:
            grads, metrics = accumulated(params, batch)
        else:
            grads, metrics = loss_and_grads(params, cfg, batch, run)
        params, opt_state, stats = adamw.apply_update(
            params, grads, opt_state, run.opt, inplace=donate)
        metrics = dict(metrics)
        metrics.update(stats)
        return params, opt_state, metrics

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
