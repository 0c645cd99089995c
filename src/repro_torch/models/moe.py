"""Mixture-of-Experts FFN: shared + fine-grained routed experts (DeepSeekMoE).

Port of ``repro/models/moe.py``.  Dispatch is
GShard-style with a capacity factor: each token's top-k assignments are
scattered into an expert buffer (position = rank of the assignment among
its expert's, from an exclusive cumsum over the one-hot assignment matrix
in token order, slot by slot and then k), run through batched expert
SwiGLUs, and gathered back weighted by the normalised router gates.
Assignments past an expert's capacity are dropped.  The router runs in
fp32 whatever the compute dtype.

Two entries:

* :func:`moe_ffn` is the reference's function, in the layout the active
  :class:`~repro_torch.distributed.context.MeshPlan` selects, by the
  reference's tests: *global* (the default), every token of ``x (B, S,
  d)`` one routing group of B*S tokens; *hierarchical*, Z = ``n_data``
  groups of B*S/Z tokens (one a data shard), each routed with its own
  capacity, the aux the mean of the groups'; *shard_map*, routing and
  capacity per data shard with the experts in ``n_model`` slices whose
  partial combines are summed.  Under a plan whose mesh is a
  :class:`~repro_torch.launch.mesh.MeshShape` every data shard runs in
  this one process, and there the slices' partial combines sum to the
  whole combine, so shard_map computes the hierarchical layout at Z =
  ``n_data``.  Across a train mesh of ranks (:func:`_moe_ffn_ranks`) the
  global layout stays one routing group over the global batch, made
  exact by one exchange of per-expert counts a layer, and the
  hierarchical and shard_map layouts route each data rank's tokens with
  capacity of their own, Z = ``n_data``; the experts split over
  ``model`` either way.
* :func:`moe_ffn_rows` is the serve path's: each sequence position of
  ``x`` is its own group of B tokens with capacity ``_capacity(m, B)``,
  so a chunk of w rows routes and drops exactly as the reference's chunk
  step, which runs its one-token cell (one group of B tokens) once per
  chunk row.  The groups share one set of expert products: their buffers
  are laid out ``(E, groups * C, d)``, so every expert's weights are read
  once a call.

Expert parallelism (a :class:`~repro_torch.models.layers.MeshContext`
whose rules split the expert stacks over ``model``): each rank routes its
slots' tokens whole, dispatches into the rows of its E/M experts only
(``_dispatch``'s ``experts``), runs them and combines only the
assignments routed to them, as the
reference's ``_moe_ffn_shard_map`` does; the shared expert is
column-parallel, and the partial outputs are summed over ``model`` once,
in fp32.  Capacity comes from the step's full slot count, as the
reference's global layout counts every slot.

A dropped assignment goes through ``index_add_`` into one spare buffer row
that no expert reads, where the reference's scatter drops it
(``mode="drop"``); its combine gathers a clamped row and zeroes it.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as mesh_ctx
from repro_torch.models import layers
from repro_torch.models.layers import MeshContext


#: where :func:`record_drops` collects the dropped assignments
_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def record_drops():
    """Collect, while open, each routing call's count of dropped
    assignments (0-d tensors), a layer's on this process (under the global
    layout across data ranks, this data rank's tokens'); a remat's
    recompute counts again."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def init_moe(gen: torch.Generator, cfg, dtype, device) -> dict:
    """The router (fp32), the routed expert stacks ``wi_gate``/``wi_up``
    ``(E, d, f)`` and ``wo`` ``(E, f, d)``, and the shared experts as one
    SwiGLU of ``n_shared * f`` columns, with the reference's names."""
    m, d = cfg.moe, cfg.d_model
    e, f = m.n_routed, m.d_ff_expert
    p = {
        "router": layers.truncated_normal(gen, (d, e), 1.0, torch.float32,
                                          device),
        "wi_gate": layers.truncated_normal_stack(gen, (e, d, f), 1.0, dtype,
                                                 device),
        "wi_up": layers.truncated_normal_stack(gen, (e, d, f), 1.0, dtype,
                                               device),
        "wo": layers.truncated_normal_stack(gen, (e, f, d), 1.0, dtype,
                                            device),
    }
    if m.n_shared > 0:
        p["shared"] = layers.swiglu_init(gen, d, m.n_shared * f, dtype,
                                         device)
    return p


def _capacity(m, T: int) -> int:
    C = int(math.ceil(m.top_k * T / m.n_routed * m.capacity_factor))
    return max(8, -(-C // 8) * 8)  # round up to a multiple of 8


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last dim and their indices, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gate(params, m, xf: torch.Tensor):
    """(..., T, d) -> the router's probs (..., T, E) (fp32), and each
    token's top-k experts' gates, renormalised, and indices (..., T, K)."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, m.top_k)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def _route(params, m, xf: torch.Tensor, aux: bool = True):
    """(..., T, d) -> gates (..., T, K), idx (..., T, K) and the Switch
    load-balance aux ``E * sum_e f_e * p_e`` of each group of T tokens,
    shape (...) (None with ``aux=False``)."""
    E, K = m.n_routed, m.top_k
    T = xf.shape[-2]
    probs, gates, idx = _gate(params, m, xf)
    if not aux:
        return gates, idx, None
    groups = probs.shape[:-2]
    G = math.prod(groups)
    me = probs.mean(dim=-2).reshape(G, E)
    offs = torch.arange(G, device=xf.device)[:, None] * E
    counts = torch.zeros(G * E, dtype=torch.float32, device=xf.device)
    counts.index_add_(0, (idx.reshape(G, T * K) + offs).reshape(-1),
                      torch.ones(G * T * K, device=xf.device))
    ce = counts.view(G, E) / (T * K)
    return gates, idx, (E * torch.sum(me * ce, dim=-1)).reshape(groups)


def _dispatch(m, xf: torch.Tensor, idx: torch.Tensor, C: int,
              offset: Optional[torch.Tensor] = None,
              experts: Optional[Tuple[int, int]] = None):
    """Scatter G groups of tokens ``xf (G, T, d)`` with assignments ``idx
    (G, T, K)`` into the ``(E, G * C, d)`` buffer, group g of expert e at
    rows ``[g * C, (g + 1) * C)``; returns (buf, slot, keep), ``slot (G,
    T * K)`` each assignment's row of the flat ``(E * G * C, d)`` buffer
    (``E * G * C`` where dropped) and ``keep`` where it was not.

    An assignment's row in its group is its rank among the group's
    assignments to its expert, plus ``offset[e]`` where given (those that
    come before the group's, on other ranks); past ``C`` it is dropped,
    and :func:`record_drops` counts it.  ``experts = (e0, n)`` keeps only
    experts ``[e0, e0 + n)``'s rows, a ``(n, G * C, d)`` buffer, and
    drops the other experts' assignments from ``keep``."""
    E, K = m.n_routed, m.top_k
    G, T, d = xf.shape
    e_flat = idx.reshape(G, T * K)
    onehot = F.one_hot(e_flat, E)  # (G, T*K, E)
    pos = onehot.cumsum(dim=1) - onehot  # exclusive cumsum, token order
    pos = pos.gather(2, e_flat[..., None])[..., 0]  # (G, T*K)
    if offset is not None:
        pos = pos + offset[e_flat]
    keep = pos < C
    if _DROPS is not None:
        _DROPS.append((~keep).sum())
    e0, n = (0, E) if experts is None else experts
    if experts is not None:
        keep = keep & (e_flat >= e0) & (e_flat < e0 + n)
    group = torch.arange(G, device=xf.device)[:, None]
    rows = n * G * C
    slot = torch.where(keep, (e_flat - e0) * (G * C) + group * C + pos,
                       rows)
    x_rep = xf[:, :, None, :].expand(G, T, K, d).reshape(G * T * K, d)
    buf = torch.zeros((rows + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot.reshape(-1), x_rep)  # row `rows` takes drops
    return buf[:rows].view(n, G * C, d), slot, keep


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """Gather expert outputs back to token order, gate-weighted and summed
    over K in ``dtype``: (G, T, d).  ``out_buf`` is the ``(E, G * C, d)``
    buffer :func:`_dispatch` gave ``slot`` and ``keep``."""
    G, TK = slot.shape
    d = out_buf.shape[-1]
    flat = out_buf.reshape(-1, d)
    y_rep = flat[slot.clamp(0, flat.shape[0] - 1).reshape(-1)]
    y_rep = torch.where(keep.reshape(-1, 1), y_rep, 0)
    w = gates.reshape(-1).to(dtype)
    return (y_rep * w[:, None]).reshape(G, TK // K, K, d).sum(dim=2)


def _expert_gemms(params, buf: torch.Tensor, dtype) -> torch.Tensor:
    """Batched expert SwiGLU: buf (E, R, d) -> (E, R, d), on the expert
    stacks ``params`` holds (this rank's under a mesh)."""
    g = torch.bmm(buf, params["wi_gate"].to(dtype))
    u = torch.bmm(buf, params["wi_up"].to(dtype))
    return torch.bmm(F.silu(g) * u, params["wo"].to(dtype))


def _shared_experts(params, x: torch.Tensor) -> torch.Tensor:
    """The shared experts, one SwiGLU every token goes through; under a
    mesh whose rules split its columns, this rank's partial output."""
    return layers.swiglu(params["shared"], x)


def moe_ffn(params, cfg, x: torch.Tensor,
            mesh: Optional[MeshContext] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux) in the layout the active plan selects (the
    module docstring): Z = ``n_data`` routing groups where its mesh is set
    for shard_map, B splits over its data shards and its model axis over
    the experts, or where it asks for hierarchical, Z > 1 splits B and
    each shard has at least ``top_k`` tokens; else the global layout, all
    B*S tokens one routing group.

    Under a train step's ``mesh``, ``x`` is this data rank's rows and the
    layouts run across the ranks (:func:`_moe_ffn_ranks`)."""
    m = cfg.moe
    B, S, _ = x.shape
    plan = mesh_ctx.current()
    if mesh is not None and mesh.train:
        return _moe_ffn_ranks(params, cfg, x, mesh,
                              plan.moe_impl != "global")
    Z = plan.n_data
    if plan.moe_impl == "shard_map" and plan.mesh is not None:
        grouped = B % Z == 0 and m.n_routed % plan.n_model == 0
    else:
        # B % Z: a token shard must be whole sequences of one data shard
        grouped = (plan.moe_hierarchical and Z > 1 and B % Z == 0
                   and B * S // Z >= m.top_k)
    return _moe_ffn_grouped(params, cfg, x, Z if grouped else 1)


def _moe_ffn_ranks(params, cfg, x: torch.Tensor, mesh: MeshContext,
                   per_rank: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layouts across a train mesh of ranks; x (B, S, d) is this data
    rank's rows (a contiguous block of the global batch, rank r the r-th).

    The **global** layout (``per_rank`` False) equals the reference's
    one-group ``moe_ffn`` over the global batch: capacity is
    ``_capacity(m, T_global)``, and an assignment's slot in its expert's
    buffer is its rank in the flat (T_global, K) order, which is the
    count of assignments to that expert on the data ranks below this one
    (one all-gather of each rank's ``(E,)`` counts, ``_dispatch``'s
    ``offset``) plus its local exclusive cumsum.  The Switch aux reads
    the per-expert sums of ``probs`` (summed over ``data``, the sum
    carrying gradient back to each rank's own tokens) and of the one-hot
    counts.  The **hierarchical** and **shard_map** layouts (``per_rank``)
    route each data rank's tokens as a group of their own, with capacity
    ``_capacity(m, T_local)``, and the aux is the mean of the ranks'.

    Either way each model rank runs its ``E/M`` experts (where the rules
    split the stacks) on its rows of the buffer and combines only the
    assignments routed to them; the shared experts are column- then
    row-parallel, and one sum over ``model`` adds the partial outputs.
    Every data rank's aux is the layout's whole aux."""
    m = cfg.moe
    E, K = m.n_routed, m.top_k
    B, S, d = x.shape
    T = B * S
    view = mesh.mesh
    n_data = view.axis_size("data")
    xf = x.reshape(1, T, d)
    split = mesh.experts_split
    if per_rank:
        gates, idx, aux = _route(params, m, xf)
        C, offset = _capacity(m, T), None
        aux = view.sum(aux[0], "data") / n_data
    else:
        probs, gates, idx = _gate(params, m, xf)
        counts = torch.bincount(idx.reshape(-1), minlength=E)  # this rank's
        every = view.base.gather(counts[None], "data", 0)  # (D, E)
        offset = every[:view.axis_index("data")].sum(dim=0)
        T_all = T * n_data
        C = _capacity(m, T_all)
        ce = every.sum(dim=0).float() / (T_all * K)
        me = view.sum(probs[0].sum(dim=0), "data") / T_all
        aux = E * torch.sum(me * ce)
    experts, xe = None, xf
    if split:  # this rank's experts, and its share of the gates
        n_loc = params["wi_gate"].shape[0]
        experts = (view.axis_index("model") * n_loc, n_loc)
        gates, xe = mesh.copy(gates), mesh.copy(xf)
    buf, slot, keep = _dispatch(m, xe, idx, C, offset, experts)
    out_buf = _expert_gemms(params, buf, x.dtype)
    y = _combine(out_buf, slot, keep, gates, K, x.dtype)[0]  # (T, d)
    partial, whole = (y, None) if split else (None, y)
    if m.n_shared > 0:
        if mesh.shared_split:
            s = _shared_experts(params, (xe if split else mesh.copy(xf))[0])
            partial = s if partial is None else partial + s
        else:
            s = _shared_experts(params, xf[0])
            whole = s if whole is None else whole + s
    if partial is None:
        y = whole
    else:
        y = layers.row_parallel(partial, view)
        y = y if whole is None else y + whole
    return y.reshape(B, S, d), aux


def _moe_ffn_grouped(params, cfg, x: torch.Tensor, Z: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z routing groups of T/Z tokens (group z holds batch rows ``[z *
    B/Z, (z + 1) * B/Z)``), each routed with capacity ``_capacity(m,
    T/Z)`` into its own rows of one ``(E, Z * C, d)`` buffer; the aux is
    the mean of the groups'.  Z = 1 is the global layout, Z = ``n_data``
    the hierarchical one."""
    m = cfg.moe
    B, S, d = x.shape
    Tl = B * S // Z
    xf = x.reshape(Z, Tl, d)
    gates, idx, aux = _route(params, m, xf)
    buf, slot, keep = _dispatch(m, xf, idx, _capacity(m, Tl))
    out_buf = _expert_gemms(params, buf, x.dtype)
    y = _combine(out_buf, slot, keep, gates, m.top_k, x.dtype)  # (Z, Tl, d)
    if m.n_shared > 0:
        y = y + _shared_experts(params, xf)
    return y.reshape(B, S, d), aux.mean()


def moe_ffn_rows(params, cfg, x: torch.Tensor,
                 mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """x: (B, S, d) -> y (B, S, d), each sequence position its own routing
    group of B tokens (slot order), with capacity ``_capacity(m, B)``:
    equal to :func:`moe_ffn` called on each ``x[:, c:c + 1]``, drops
    included.  Under ``mesh``, ``x`` holds this rank's slots and capacity
    comes from the step's full slot count; split expert stacks and shared
    columns give partial outputs, summed over ``model`` in fp32."""
    m = cfg.moe
    B, S, d = x.shape
    xg = x.transpose(0, 1)  # (S, B, d): group c holds every slot's row c
    gates, idx, _ = _route(params, m, xg.reshape(S * B, d), aux=False)
    C = _capacity(m, B if mesh is None else mesh.batch)
    split = mesh is not None and mesh.experts_split
    experts = None
    if split:  # this rank's experts: a slice of the buffer's expert axis
        n_loc = params["wi_gate"].shape[0]
        experts = (mesh.mesh.axis_index("model") * n_loc, n_loc)
    buf, slot, keep = _dispatch(m, xg, idx.reshape(S, B, m.top_k), C,
                                experts=experts)
    out_buf = _expert_gemms(params, buf, x.dtype)
    y = _combine(out_buf, slot, keep, gates.reshape(S, B, m.top_k),
                 m.top_k, x.dtype).transpose(0, 1)  # (B, S, d)
    shared = m.n_shared > 0
    shared_split = shared and mesh is not None and mesh.shared_split
    if shared and shared_split == split:  # both partial or both whole
        y = y + _shared_experts(params, x)
    if split:
        y = layers.row_parallel(y, mesh.mesh)
    if shared and shared_split != split:
        s = _shared_experts(params, x)
        y = y + (layers.row_parallel(s, mesh.mesh) if shared_split else s)
    return y
