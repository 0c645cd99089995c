"""Divisibility-aware sharding rules for tensor-parallel serving, and the
cut of a full tensor to one rank's shard.

Port of ``repro/distributed/sharding.py``: the parameter rules
(``_RULES``, ``spec_for_path``, ``param_shardings`` for training and
``serve_param_shardings`` for serving), ``batch_spec``,
``paged_cache_spec``, ``paged_cache_shardings``, ``replicated``, and
ZeRO's ``zero_shard_spec`` and ``opt_state_shardings``.  A spec is a tuple with one
entry a dimension: None (replicated), an axis name, or a tuple of axis
names.  A mesh is anything with ``axis_names`` and ``axis_size(name)``
(:class:`repro_torch.launch.mesh.MeshShape`, or a rank's ``ServeMesh``).

Megatron-style tensor parallelism over the ``model`` axis: embeddings and
the LM head split the vocab, q/k/v and FFN up/gate are column-parallel,
the attention output and FFN down projections are row-parallel, and
everything else is replicated.  A dimension is split on an axis only if
the axis divides it; otherwise the rule falls back to its next candidate
or to replication.  The paged K/V pools split their head axis over
``model`` (their block axis stays replicated, so any slot's table can name
any block), their int8 scale pools stay whole, and the serving slots split
over ``data`` where ``data`` divides them.

Training places parameters by the rules alone (no serving exception), and
ZeRO adds the data axes to the first dim of each optimizer-state leaf
that is not split and that they divide.  The port's parameters are one
dict a layer where the reference stacks the layers of a superblock, so
each rule and ZeRO's placement read a layer's own leaf: a leaf the
reference splits on its stacked layer dim is split here on its first
divisible dim of its own.  A rank's leaf is its block of the spec
(:func:`local_shard`); placement never changes a value.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Tuple

Spec = Tuple[Any, ...]

# (path-regex, candidate specs tried in order; the first that fits wins).
# Regexes match the "/"-joined parameter path, e.g. "layers/0/attn/wq/w".
_RULES = [
    # attention / mla / dense projections: column-parallel
    (r"(wq|wk|wv|w_uk|w_uv|wz|wx|wdt|lm_head)/w$",
     [(None, "model"), (None, None)]),
    (r"(wq|wk|wv|wz|wx|wdt)/b$", [("model",), (None,)]),
    # row-parallel (the contracting dim split)
    (r"(wo|out_proj)/w$", [("model", None), (None, None)]),
    (r"(wo|out_proj)/b$", [(None,)]),
    # embeddings: vocab over model
    (r"embed(ding)?s?/embedding$", [("model", None), (None, None)]),
    # MoE expert stacks (E, d, f) / (E, f, d): expert-parallel
    (r"moe/(wi_gate|wi_up|wo)$",
     [("model", None, None), (None, None, None)]),
    (r"moe/router$", [(None, None)]),
    # dense / shared-expert SwiGLU FFN (raw arrays, not {w, b} dicts)
    (r"(ffn|shared)/(wi_gate|wi_up)$", [(None, "model"), (None, None)]),
    (r"(ffn|shared)/wo$", [("model", None), (None, None)]),
    # mamba conv + small projections
    (r"conv_x_w$", [(None, "model"), (None,)]),
    # the bias's channels over model, as the taps': the reference's one
    # rule for both splits it only in its stacked (layers, d_inner) form
    (r"conv_x_b$", [("model",), (None,)]),
    (r"conv_BC_[wb]$", [(None, None), (None,)]),
    (r"wBC/w$", [(None, None)]),
    (r"wBC/b$", [(None,)]),
    (r"(A_log|D|dt_bias)$", [(None,)]),
    # kv-down (MLA) small projection
    (r"w_dkv/w$", [(None, None)]),
    # norms and leftovers: replicate
    (r".*", [(None,)]),
]


def axis_size(mesh, name: str) -> int:
    return mesh.axis_size(name) if name in mesh.axis_names else 1


def data_axes(mesh) -> tuple:
    """Axes that carry the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _mesh_size(mesh) -> int:
    size = 1
    for name in mesh.axis_names:
        size *= mesh.axis_size(name)
    return size


def _names(axes) -> tuple:
    return axes if isinstance(axes, tuple) else (axes,)


def _fits(spec: Spec, shape, mesh) -> bool:
    if len(spec) > len(shape):
        return False
    for dim, axes in zip(shape[-len(spec):] if spec else (), spec):
        if axes is None:
            continue
        size = 1
        for n in _names(axes):
            if n not in mesh.axis_names:
                return False
            size *= axis_size(mesh, n)
        if dim % size != 0:
            return False
    return True


def _pad_spec(spec: Spec, rank: int) -> Spec:
    """Left-pad with None for stacked leading axes (layers)."""
    return (None,) * (rank - len(spec)) + tuple(spec)


def spec_for_path(path: str, shape, mesh) -> Spec:
    for pattern, candidates in _RULES:
        if re.search(pattern, path):
            for cand in candidates:
                if _fits(cand, shape, mesh):
                    return _pad_spec(cand, len(shape))
            return (None,) * len(shape)
    return (None,) * len(shape)


def param_shardings(params, mesh):
    """The spec tree the train step places a parameter tree by: each
    leaf's :func:`spec_for_path` on its full shape."""
    return map_paths(params, lambda path, leaf: spec_for_path(
        path, tuple(leaf.shape), mesh))


def zero_shard_spec(param_spec: Spec, shape, mesh) -> Spec:
    """``param_spec`` with the data axes added to the first unsplit dim
    of ``shape`` that they divide (ZeRO), or as it is when there is none
    or the mesh has no data axes."""
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= axis_size(mesh, a)
    if not dp:
        return tuple(param_spec)
    dims = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (d, s) in enumerate(zip(shape, dims)):
        if s is None and d % dp_size == 0 and d > 0:
            dims[i] = dp if len(dp) > 1 else dp[0]
            return tuple(dims)
    return tuple(dims)


def opt_state_shardings(params, p_specs, mesh, *, zero: bool = True):
    """The spec tree of AdamW's per-parameter state (``m``, ``v``,
    ``master``): the parameters' specs, with ZeRO's data axes added where
    ``zero``."""
    if not zero:
        return p_specs
    return _map2(params, p_specs, lambda leaf, spec: zero_shard_spec(
        spec, tuple(leaf.shape), mesh))


def _map2(tree, other, fn):
    if isinstance(tree, Mapping):
        return {k: _map2(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(v, other[i], fn) for i, v in enumerate(tree)]
    return fn(tree, other)


def train_params(params, mesh):
    """This rank's shard of every leaf of a full parameter tree by
    :func:`param_shardings`: views of the full leaves."""
    coords = {name: mesh.axis_index(name) for name in mesh.axis_names}
    return map_paths(params, lambda path, leaf: local_shard(
        leaf, spec_for_path(path, tuple(leaf.shape), mesh), mesh, coords))


def data_dim(spec: Spec):
    """The dim of ``spec`` that names the data axis, or None."""
    for i, axes in enumerate(spec):
        if axes is not None and "data" in _names(axes):
            return i
    return None


def map_paths(tree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its
    structure; paths are "/"-joined keys and list indices."""
    if isinstance(tree, Mapping):
        return {k: map_paths(v, fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_paths(v, fn, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def serve_spec(path: str, shape, mesh) -> Spec:
    """:func:`spec_for_path` with the serve path's mamba exception: on a
    2-D mesh (data and model both > 1) leaves under a ``mamba`` path
    segment are replicated (the empty spec), as the reference's serving
    does."""
    m = axis_size(mesh, "model")
    if m > 1 and _mesh_size(mesh) != m and "mamba" in path.split("/"):
        return ()
    return spec_for_path(path, shape, mesh)


def serve_param_shardings(params, mesh):
    """The spec tree the serving path places a parameter tree by."""
    return map_paths(params, lambda path, leaf: serve_spec(
        path, tuple(leaf.shape), mesh))


def local_params(params, mesh):
    """This rank's shard of every leaf of a full parameter tree (torch
    tensors or numpy arrays), by :func:`serve_param_shardings`: views of
    the full leaves."""
    coords = {name: mesh.axis_index(name) for name in mesh.axis_names}
    return map_paths(params, lambda path, leaf: local_shard(
        leaf, serve_spec(path, tuple(leaf.shape), mesh), mesh, coords))


def batch_spec(mesh, batch: int, rank: int, *,
               seq_axis: Optional[int] = None, seq_len: int = 0) -> Spec:
    """Split dim 0 (batch) over the data axes; if the batch does not
    divide, split the sequence dim instead where it does."""
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= axis_size(mesh, a)
    dims = [None] * rank
    if batch % dp_size == 0:
        dims[0] = dp if len(dp) > 1 else dp[0]
    elif seq_axis is not None and seq_len % dp_size == 0:
        dims[seq_axis] = dp if len(dp) > 1 else dp[0]
    return tuple(dims)


def paged_cache_spec(key: str, shape, mesh) -> Spec:
    """The spec of one leaf of a paged serve cache, by leaf name.

    ``k``/``v`` pools ``(..., n_blocks, bs, KV, hd)``: KV heads over
    ``model`` when it divides them, the block axis replicated.  ``*_scale``
    int8 pools: replicated (scales are per token row, not per head).  The
    recurrent ``ssm_state`` ``(nsb, B, H, d_state, hd)`` and
    ``conv_state`` ``(nsb, B, d_conv-1, ch)`` split only on a single-axis
    mesh, heads/channels over ``model`` or slots over ``data``.  Anything
    else (the MLA latent pools) is replicated.
    """
    m = axis_size(mesh, "model")
    dp = data_axes(mesh)
    dp_axes = dp if len(dp) > 1 else (dp[0] if dp else None)
    dp_size = 1
    for a in dp:
        dp_size *= axis_size(mesh, a)
    dims = [None] * len(shape)
    if key.endswith("_scale"):
        return tuple(dims)
    if key in ("k", "v") and len(shape) >= 4:
        head_ax = len(shape) - 2
        if shape[head_ax] % m == 0:
            dims[head_ax] = "model"
        return tuple(dims)
    flat = _mesh_size(mesh)
    if key == "ssm_state" and len(shape) == 5:
        if m > 1 and flat == m and shape[2] % m == 0:
            dims[2] = "model"
        elif dp and flat == dp_size and shape[1] % dp_size == 0:
            dims[1] = dp_axes
        return tuple(dims)
    if key == "conv_state" and len(shape) == 4:
        if m > 1 and flat == m and shape[-1] % m == 0:
            dims[-1] = "model"
        elif dp and flat == dp_size and shape[1] % dp_size == 0:
            dims[1] = dp_axes
        return tuple(dims)
    return tuple(dims)


def paged_cache_shardings(cache: Mapping, mesh) -> dict:
    """The spec of every leaf of a paged cache dict, by its key."""
    return {key: paged_cache_spec(key, tuple(leaf.shape), mesh)
            for key, leaf in cache.items()}


def replicated(mesh) -> Spec:
    """The replicated spec: host-side slot accounting (positions, block
    tables, the free list) is the same on every rank."""
    return ()


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under
    ``spec``."""
    spec = _pad_spec(spec, len(shape))
    out = []
    for dim, axes in zip(shape, spec):
        n = 1
        for name in (() if axes is None else _names(axes)):
            n *= axis_size(mesh, name)
        out.append(dim // n)
    return tuple(out)


def local_shard(x, spec: Spec, mesh, coords: Mapping[str, int]):
    """Rank ``coords`` ({axis: index})'s shard of the full tensor or array
    ``x`` under ``spec``: each split dim cut to its contiguous block, the
    block of a tuple of axes indexed major to minor.  A view, not a
    copy."""
    spec = _pad_spec(spec, x.ndim)
    index = []
    for dim, axes in zip(x.shape, spec):
        if axes is None:
            index.append(slice(None))
            continue
        n, i = 1, 0
        for name in _names(axes):
            size = axis_size(mesh, name)
            i = i * size + coords.get(name, 0)
            n *= size
        per = dim // n
        index.append(slice(i * per, (i + 1) * per))
    return x[tuple(index)]


def local_slots(mesh, batch: int) -> slice:
    """The serving slots this rank computes: its contiguous block of
    ``batch`` when :func:`batch_spec` splits slots over ``data``, all of
    them otherwise."""
    if batch_spec(mesh, batch, 1)[0] is None:
        return slice(0, batch)
    per = batch // axis_size(mesh, "data")
    i = mesh.axis_index("data")
    return slice(i * per, (i + 1) * per)
