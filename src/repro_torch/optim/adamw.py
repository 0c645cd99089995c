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
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding

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
                         device="cuda", *, layout=None) -> Dict[str, Any]:
    """The reference's optimizer state of a ``cfg`` model (``step``,
    ``m``, ``v`` and ``master``, each leaf a numpy array, e.g. ``np.asarray``
    of every leaf of ``repro.optim.adamw.init_opt_state`` or of a train
    step's output) as the port's: the moments and masters through the
    parameters' layout map of ``cfg``'s family
    (:func:`~repro_torch.train.steps.params_from_numpy`), in
    ``opt_cfg.state_dtype`` and fp32, and the step on the host.  With a
    :class:`ShardLayout`, this rank's shard of it."""
    from repro_torch.train.steps import params_from_numpy

    sdt = _state_dtype(opt_cfg)
    state = {"step": torch.tensor(int(np.asarray(tree["step"])),
                                  dtype=torch.int32)}
    for key in ("m", "v", "master"):
        if key in tree:
            state[key] = params_from_numpy(
                tree[key], cfg, "cpu" if layout is not None else device,
                dtype=_F32 if key == "master" else sdt)
    return state if layout is None else layout.cut_state(state, device)


def global_norm(tree: Any) -> torch.Tensor:
    """fp32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


# -- a rank's shards on a train mesh ------------------------------------------


def _map_indexed(fn: Callable, tree: Any, *rest: Any) -> Any:
    """:func:`tree_map` with each leaf's index in :func:`tree_leaves`
    order as ``fn``'s first argument."""
    counter = iter(range(len(tree_leaves(tree))))
    return tree_map(lambda *leaves: fn(next(counter), *leaves), tree, *rest)


def _names(spec) -> set:
    out = set()
    for axes in spec:
        if axes is not None:
            out.update(axes if isinstance(axes, tuple) else (axes,))
    return out


#: the optimizer state's leaves that follow the parameters
_PER_PARAM = ("m", "v", "master")


def state_bytes(state: Dict[str, Any]) -> int:
    """The bytes of an optimizer state's per-parameter leaves."""
    return sum(t.numel() * t.element_size() for k in _PER_PARAM
               if k in state for t in tree_leaves(state[k]))


class ShardLayout:
    """Where a rank's leaves of the parameters, their gradients and
    AdamW's state lie in the full trees, on a train mesh of ranks.

    ``shapes`` is a tree of the full parameters (anything with
    ``.shape``); ``p_specs`` and ``z_specs`` are its train specs without
    and with ZeRO's data axes (``sharding.param_shardings``,
    ``sharding.opt_state_shardings``), and ``o_specs`` the state's, one or
    the other by ``zero``.  A leaf's *shard* is its block of the z spec:
    the gradient norm reads every leaf's shard, ZeRO's state holds it.  A
    leaf the data axes divide no dim of has one shard, the whole block,
    which every data rank holds and data rank 0 counts.

    The data-parallel gradient sum is one flat buffer a dtype, laid out
    as the ``D`` ranks' blocks of the split leaves, each block every such
    leaf's shard in leaf order, then the whole leaves: the all-reduce SUM
    of it, kept whole, or cut to the rank's block and the whole leaves
    (``Collectives.reduce_scatter_flat``), holds the same bits either
    way."""

    def __init__(self, shapes: Any, mesh, *, zero: bool = True):
        self.mesh, self.zero = mesh, zero
        self.p_specs = sharding.param_shardings(shapes, mesh)
        self.z_specs = sharding.opt_state_shardings(shapes, self.p_specs,
                                                    mesh, zero=True)
        self.o_specs = self.z_specs if zero else self.p_specs
        self.n_data = mesh.axis_size("data")
        self.data_index = mesh.axis_index("data")
        self.zdims = [sharding.data_dim(z)
                      for z in tree_leaves(self.z_specs)]
        first_model = mesh.axis_index("model") == 0
        self.owned = [
            (zd is not None or self.data_index == 0)
            and ("model" in _names(p) or first_model)
            for zd, p in zip(self.zdims, tree_leaves(self.p_specs))]

    # -- cutting full trees ---------------------------------------------------

    def _cut(self, full: Any, specs: Any, device) -> Any:
        coords = {name: self.mesh.axis_index(name)
                  for name in self.mesh.axis_names}
        dev = torch.device(device)
        return tree_map(lambda leaf, spec: sharding.local_shard(
            leaf, spec, self.mesh, coords).to(dev).clone(
                memory_format=torch.contiguous_format), full, specs)

    def cut_params(self, full: Any, device) -> Any:
        """This rank's parameters of a full tree, on ``device``."""
        return self._cut(full, self.p_specs, device)

    def cut_block(self, path: Tuple, block: Any, device) -> Any:
        """This rank's parameters of ``block``, the full subtree at
        ``path`` (its keys from the root) of the parameters, on
        ``device``."""
        specs = self.p_specs
        for key in path:
            specs = specs[key]
        return self._cut(block, specs, device)

    def cut_state(self, full: Dict[str, Any], device) -> Dict[str, Any]:
        """This rank's optimizer state of a full one, on ``device``."""
        out = {"step": full["step"]}
        for key in ("m", "v", "master"):
            if key in full:
                out[key] = self._cut(full[key], self.o_specs, device)
        return out

    def init_state(self, params: Any, cfg: AdamWConfig, device
                   ) -> Dict[str, Any]:
        """:func:`init_opt_state`'s state cut to this rank, made here from
        this rank's parameters (its blocks of them): zeroed moments of
        the state's shapes, and the masters the state's part of the
        blocks (under ZeRO this rank's shards of them) in fp32."""
        sdt = _state_dtype(cfg)
        dev = torch.device(device)
        part = params if not self.zero else self.shards(params)
        state = {"step": torch.zeros((), dtype=torch.int32),
                 "m": tree_map(lambda t: torch.zeros(
                     t.shape, dtype=sdt, device=dev), part),
                 "v": tree_map(lambda t: torch.zeros(
                     t.shape, dtype=sdt, device=dev), part)}
        if cfg.master_weights:
            state["master"] = tree_map(lambda t: t.to(
                device=dev, dtype=_F32, memory_format=torch.contiguous_format,
                copy=True), part)
        return state

    def block_state_bytes(self, params: Any, state: Dict[str, Any]
                          ) -> int:
        """The bytes ``state``'s per-parameter leaves (m, v, master) take
        without ZeRO: over this rank's whole ``params`` blocks."""
        n = sum(p.numel() for p in tree_leaves(params))
        return sum(n * tree_leaves(state[k])[0].element_size()
                   for k in _PER_PARAM if k in state)

    def full_params(self, params: Any) -> Any:
        """The full tree of every rank's parameters, on every rank (an
        all-gather over ``model`` a split leaf)."""
        return tree_map(lambda leaf, spec: self._gather(leaf, spec),
                        params, self.p_specs)

    def full_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The full optimizer state, on every rank."""
        out = {"step": state["step"]}
        for key in ("m", "v", "master"):
            if key in state:
                out[key] = tree_map(lambda leaf, spec: self._gather(
                    leaf, spec), state[key], self.o_specs)
        return out

    def _gather(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        spec = sharding._pad_spec(spec, leaf.dim())
        for dim, axes in enumerate(spec):
            for name in (() if axes is None else
                         (axes if isinstance(axes, tuple) else (axes,))):
                leaf = self.mesh.gather(leaf, name, dim)
        return leaf

    # -- the step ------------------------------------------------------------

    def _block(self, x: torch.Tensor, i: int, r: int) -> torch.Tensor:
        zd = self.zdims[i]
        per = x.shape[zd] // self.n_data
        return x.narrow(zd, r * per, per)

    def shards(self, tree: Any) -> Any:
        """This rank's shard of each leaf of a tree of its parameters'
        blocks (views)."""
        return _map_indexed(lambda i, x: x if self.zdims[i] is None
                            else self._block(x, i, self.data_index), tree)

    def _groups(self, leaves: List[torch.Tensor]):
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, leaf in enumerate(leaves):
            by_dtype.setdefault(leaf.dtype, []).append(i)
        for dtype in sorted(by_dtype, key=str):
            idx = by_dtype[dtype]
            yield ([i for i in idx if self.zdims[i] is not None],
                   [i for i in idx if self.zdims[i] is None])

    def reduce_grads(self, grads: Any) -> Any:
        """Every rank's gradients of its parameters summed over ``data``:
        this rank's shard of each leaf under ZeRO (a reduce-scatter), its
        whole block otherwise (an all-reduce).  ``grads`` may come in a
        one-element list, which this empties, so that each leaf is freed
        once it is in the flat buffer."""
        if isinstance(grads, list) and len(grads) == 1:
            grads = grads.pop()
        skeleton = tree_map(lambda _: None, grads)
        leaves = tree_leaves(grads)
        del grads
        shapes = [leaf.shape for leaf in leaves]
        out: List[Any] = [None] * len(leaves)
        comm, group = self.mesh.comm, self.mesh.groups.get("data")
        D = self.n_data
        for split, whole in self._groups(leaves):
            first = leaves[(split or whole)[0]]
            numel = sum(leaves[i].numel() for i in split + whole)
            flat = comm.shared_flat(("grads", first.dtype), numel,
                                    first.dtype, first.device, group, D)
            at = 0
            for r in range(D):
                for i in split:
                    part = self._block(leaves[i], i, r).reshape(-1)
                    flat[at:at + part.numel()].copy_(part)
                    at += part.numel()
            for i in split + whole:  # in the flat buffer: let go of it
                if i in whole:
                    flat[at:at + leaves[i].numel()].copy_(
                        leaves[i].reshape(-1))
                    at += leaves[i].numel()
                leaves[i] = None
            del first
            tail = sum(int(np.prod(shapes[i])) for i in whole)
            if self.zero:  # keep this rank's block, free the rest
                mine, rest = comm.reduce_scatter_flat(
                    flat, group, D, self.data_index, tail)
                blocks = {self.data_index: mine}
                del flat
            else:
                total = comm.all_reduce_flat(flat, group, D)
                per = (flat.numel() - tail) // D
                blocks = {r: total[r * per:(r + 1) * per] for r in range(D)}
                rest = total[flat.numel() - tail:]
            pieces: Dict[int, List[torch.Tensor]] = {i: [] for i in split}
            for r in sorted(blocks):
                at = 0
                for i in split:
                    shape = list(shapes[i])
                    shape[self.zdims[i]] //= D
                    n = int(np.prod(shape))
                    pieces[i].append(blocks[r][at:at + n].view(shape))
                    at += n
            for i in split:
                out[i] = torch.cat(pieces[i], dim=self.zdims[i]) \
                    if len(pieces[i]) > 1 else pieces[i][0]
            at = 0
            for i in whole:
                n = int(np.prod(shapes[i]))
                out[i] = rest[at:at + n].view(shapes[i])
                at += n
        it = iter(out)
        return tree_map(lambda _: next(it), skeleton)

    def norm(self, grads: Any) -> torch.Tensor:
        """The global fp32 L2 norm of the gradients (a tree of this rank's
        shards under ZeRO, of its blocks otherwise): each shard's sum of
        squares where this rank owns it, summed over ``data`` then
        ``model``."""
        shards = grads if self.zero else self.shards(grads)
        leaves = tree_leaves(shards)
        zero = torch.zeros((), dtype=_F32, device=leaves[0].device)
        sq = torch.stack([
            torch.sum(torch.square(leaf.float().contiguous())) if own
            else zero for leaf, own in zip(leaves, self.owned)])
        sq = self.mesh.sum(self.mesh.sum(sq, "data"), "model")
        return torch.sqrt(sq.sum())

    def gather_params(self, shards: Any, params: Any, inplace: bool
                      ) -> Any:
        """The parameters' blocks rebuilt from every data rank's updated
        shards (an all-gather over ``data`` of one flat buffer a dtype);
        with ``inplace`` written into ``params``."""
        leaves = tree_leaves(shards)
        out: List[Any] = list(leaves)
        comm, group = self.mesh.comm, self.mesh.groups.get("data")
        D = self.n_data
        dest = tree_leaves(params)
        for split, _ in self._groups(leaves):
            if not split:
                continue
            flat = comm.shared_flat(
                ("params", leaves[split[0]].dtype),
                sum(leaves[i].numel() for i in split),
                leaves[split[0]].dtype, leaves[split[0]].device, group, D)
            torch.cat([leaves[i].reshape(-1) for i in split], out=flat)
            every = comm.all_gather_flat(flat, group, D)
            per = flat.numel()
            del flat
            for i in split:  # each leaf's blocks, rank by rank, into place
                out[i] = dest[i] if inplace else torch.empty_like(dest[i])
            for r in range(D):
                at = r * per
                for i in split:
                    n = leaves[i].numel()
                    self._block(out[i], i, r).copy_(
                        every[at:at + n].view(leaves[i].shape))
                    at += n
            del every
        it = iter(out)
        new = tree_map(lambda _: next(it), params)
        if not inplace:
            return new
        # the split leaves are in place already, the others updated there
        return tree_map(lambda p, n: p if n is p else p.copy_(n), params,
                        new)


def apply_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig, *, inplace: bool = False,
                 layout: Optional[ShardLayout] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}).  Gradients
    are clipped to a global norm of ``grad_clip``; the update is computed
    in fp32 from the master weights (or the params without them) and cast
    to each param's dtype.  The given trees stay as they were unless
    ``inplace``, which writes the new values into them and returns
    them.

    With ``layout``, on a rank of a train mesh: ``params`` are its
    blocks, ``grads`` the output of ``layout.reduce_grads`` and ``state``
    its shards; under ZeRO the update runs on this rank's shards and the
    parameters are gathered back over ``data``."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if layout is None else layout.norm(grads)
    dev = gnorm.device
    scale = (cfg.grad_clip / gnorm.clamp_min(1e-9)).clamp_max(1.0)
    lr = schedule(cfg, step)
    bc1, bc2 = bias_corrections(cfg, step)
    lr_d, bc1_d, bc2_d = (t.to(dev) for t in (lr, bc1, bc2))
    b1, b2 = cfg.b1, cfg.b2
    sdt = _state_dtype(cfg)
    zero = layout is not None and layout.zero
    full = params
    if zero:
        params = layout.shards(params)
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
    if zero:
        new_params = layout.gather_params(new_params, full, inplace)
    new_state = {"step": step, "m": new_m, "v": new_v}
    if cfg.master_weights:
        new_state["master"] = new_w
    if inplace:
        state.update(new_state)
        new_state = state
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr_d}
