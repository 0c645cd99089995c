"""AdamW with fp32 master weights and grad clipping.

Port of ``repro/optim/adamw.py``: ``AdamWConfig``, ``schedule``,
``init_opt_state``, ``global_norm`` and ``apply_update``, on trees of
nested dicts and lists of tensors (the port's parameters).  Params may
live in bf16; the fp32 master copy and the moments live in the optimizer
state.

The scalars of a step follow the reference's compiled arithmetic bit for
bit where the CPU allows: the step counter lives on the host (a 0-d int32
CPU tensor, as a checkpoint restores it), and the learning rate and the
bias corrections ``1 - b ** step`` are fp32 0-d tensors computed there,
with XLA's rewrites: a division by a constant is a multiply by its fp32
reciprocal, ``b ** step`` is ``powf`` and the cosine's ``a * 0.45 + 0.1``
is one fused multiply-add.  XLA's CPU cosine is the C library's ``cosf``;
the port rounds the double cosine instead, which lands one ulp away in
a few steps of the cosine branch.  The per-element update runs on the
parameters' device.  ``apply_update(..., inplace=True)`` writes the new
params, moments and masters into the given tensors (the counterpart of
the reference's donated buffers), so a step holds one copy of the state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    master_weights: bool = True
    state_dtype: str = "float32"


# -- trees of tensors ---------------------------------------------------------


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts (keys in sorted order, as
    ``jax.tree.leaves`` orders them) and lists, in that order; anything
    else, a tuple included, is a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of its structure), in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


# -- the step's scalars -------------------------------------------------------


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def _recip(n: int) -> torch.Tensor:
    """fp32 ``1 / max(n, 1)``: XLA turns a division by a constant into a
    multiply by this."""
    return _f32(1.0) / max(n, 1)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``: the fp32 learning
    rate at ``step`` (a 0-d integer tensor), on the host."""
    s = step.to("cpu", _F32)
    warm = s * _recip(cfg.warmup_steps)
    t = ((s - cfg.warmup_steps)
         * _recip(cfg.total_steps - cfg.warmup_steps)).clamp(0.0, 1.0)
    one_cos = 1 + torch.cos((t * math.pi).double()).float()
    # min + (1 - min) * 0.5 * (1 + cos) as one fp32 fused multiply-add: the
    # double product of two fp32 values is exact, and the sum is rounded
    # once
    half_span = float(_f32((1 - cfg.min_lr_ratio) * 0.5))
    cos = (one_cos.double() * half_span
           + float(_f32(cfg.min_lr_ratio))).float()
    return torch.where(s < cfg.warmup_steps, warm, cos) * cfg.lr


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(1 - b1 ** step, 1 - b2 ** step)`` on the host."""
    s = step.to("cpu", _F32)
    return 1 - torch.pow(_f32(cfg.b1), s), 1 - torch.pow(_f32(cfg.b2), s)


# -- state and update ---------------------------------------------------------


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    dtype = getattr(torch, cfg.state_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    return dtype


def init_opt_state(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """``step`` (0-d int32 on the host), zeroed moments ``m`` and ``v`` in
    ``state_dtype`` beside each param, and with ``master_weights`` an fp32
    copy of every param (a copy even of an fp32 param, so that updating
    one in place never moves the other)."""
    sdt = _state_dtype(cfg)
    state = {
        "step": torch.zeros((), dtype=torch.int32),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params),
    }
    if cfg.master_weights:
        state["master"] = tree_map(
            lambda p: p.detach().to(_F32, copy=True), params)
    return state


def opt_state_from_numpy(tree: Dict[str, Any], cfg, opt_cfg: AdamWConfig,
                         device="cuda") -> Dict[str, Any]:
    """The reference's optimizer state of a ``cfg`` model (``step``,
    ``m``, ``v`` and ``master``, each leaf a numpy array, e.g. ``np.asarray``
    of every leaf of ``repro.optim.adamw.init_opt_state`` or of a train
    step's output) as the port's: the moments and masters through the
    parameters' layout map of ``cfg``'s family
    (:func:`~repro_torch.train.steps.params_from_numpy`), in
    ``opt_cfg.state_dtype`` and fp32, and the step on the host."""
    from repro_torch.train.steps import params_from_numpy

    sdt = _state_dtype(opt_cfg)
    state = {"step": torch.tensor(int(np.asarray(tree["step"])),
                                  dtype=torch.int32)}
    for key in ("m", "v", "master"):
        if key in tree:
            state[key] = params_from_numpy(
                tree[key], cfg, device,
                dtype=_F32 if key == "master" else sdt)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """fp32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def apply_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig, *, inplace: bool = False
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}).  Gradients
    are clipped to a global norm of ``grad_clip``; the update is computed
    in fp32 from the master weights (or the params without them) and cast
    to each param's dtype.  The given trees stay as they were unless
    ``inplace``, which writes the new values into them and returns
    them."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = (cfg.grad_clip / gnorm.clamp_min(1e-9)).clamp_max(1.0)
    lr = schedule(cfg, step)
    bc1, bc2 = bias_corrections(cfg, step)
    lr_d, bc1_d, bc2_d = (t.to(dev) for t in (lr, bc1, bc2))
    b1, b2 = cfg.b1, cfg.b2
    sdt = _state_dtype(cfg)
    masters = state["master"] if cfg.master_weights else params

    def upd(p, g, m, v, w):
        g32 = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * torch.square(g32)
        mhat = m_new / bc1_d
        vhat = v_new / bc2_d
        w32 = w.float()
        step_w = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * w32
        w_new = w32 - lr_d * step_w
        if not inplace:
            return (w_new.to(p.dtype), m_new.to(sdt), v_new.to(sdt), w_new)
        for dst, src in ((m, m_new), (v, v_new), (p, w_new)):
            dst.copy_(src)
        if w is not p:
            w.copy_(w_new)
        return p, m, v, w

    out = tree_map(upd, params, grads, state["m"], state["v"], masters)
    new_params, new_m, new_v, new_w = (
        tree_map(lambda t, i=i: t[i], out) for i in range(4))
    new_state = {"step": step, "m": new_m, "v": new_v}
    if cfg.master_weights:
        new_state["master"] = new_w
    if inplace:
        state.update(new_state)
        new_state = state
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr_d}
