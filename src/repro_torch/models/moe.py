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
  ``n_data``; a mesh of ranks, where the slices live on different ranks,
  is the train mesh's (ROADMAP item 1.18.2).
* :func:`moe_ffn_rows` is the serve path's: each sequence position of
  ``x`` is its own group of B tokens with capacity ``_capacity(m, B)``,
  so a chunk of w rows routes and drops exactly as the reference's chunk
  step, which runs its one-token cell (one group of B tokens) once per
  chunk row.  The groups share one set of expert products: their buffers
  are laid out ``(E, groups * C, d)``, so every expert's weights are read
  once a call.

Expert parallelism (a :class:`~repro_torch.models.layers.MeshContext`
whose rules split the expert stacks over ``model``): each rank routes and
dispatches its slots' tokens whole, runs its E/M experts on its slice of
the buffer and combines only the assignments routed to them, as the
reference's ``_moe_ffn_shard_map`` does; the shared expert is
column-parallel, and the partial outputs are summed over ``model`` once,
in fp32.  Capacity comes from the step's full slot count, as the
reference's global layout counts every slot.

A dropped assignment goes through ``index_add_`` into one spare buffer row
that no expert reads, where the reference's scatter drops it
(``mode="drop"``); its combine gathers a clamped row and zeroes it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as mesh_ctx
from repro_torch.models import layers
from repro_torch.models.layers import MeshContext


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


def _route(params, m, xf: torch.Tensor, aux: bool = True):
    """(..., T, d) -> gates (..., T, K), idx (..., T, K) and the Switch
    load-balance aux ``E * sum_e f_e * p_e`` of each group of T tokens,
    shape (...) (None with ``aux=False``)."""
    E, K = m.n_routed, m.top_k
    T = xf.shape[-2]
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (..., T, E)
    gates, idx = _top_k(probs, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
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


def _dispatch(m, xf: torch.Tensor, idx: torch.Tensor, C: int):
    """Scatter G groups of tokens ``xf (G, T, d)`` with assignments ``idx
    (G, T, K)`` into the ``(E, G * C, d)`` buffer, group g of expert e at
    rows ``[g * C, (g + 1) * C)``; returns (buf, slot, keep), ``slot (G,
    T * K)`` each assignment's row of the flat ``(E * G * C, d)`` buffer
    (``E * G * C`` where dropped) and ``keep`` where it was not."""
    E, K = m.n_routed, m.top_k
    G, T, d = xf.shape
    e_flat = idx.reshape(G, T * K)
    onehot = F.one_hot(e_flat, E)  # (G, T*K, E)
    pos = onehot.cumsum(dim=1) - onehot  # exclusive cumsum, token order
    pos = pos.gather(2, e_flat[..., None])[..., 0]  # (G, T*K)
    keep = pos < C
    group = torch.arange(G, device=xf.device)[:, None]
    rows = E * G * C
    slot = torch.where(keep, e_flat * (G * C) + group * C + pos, rows)
    x_rep = xf[:, :, None, :].expand(G, T, K, d).reshape(G * T * K, d)
    buf = torch.zeros((rows + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot.reshape(-1), x_rep)  # row `rows` takes drops
    return buf[:rows].view(E, G * C, d), slot, keep


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, K: int, dtype,
             first: Optional[int] = None) -> torch.Tensor:
    """Gather expert outputs back to token order, gate-weighted and summed
    over K in ``dtype``: (G, T, d).  ``out_buf`` is the whole ``(E, G *
    C, d)`` buffer, or with ``first`` the slice of it that holds the flat
    rows from ``first`` on: assignments to rows outside it, like dropped
    ones, add nothing."""
    G, TK = slot.shape
    d = out_buf.shape[-1]
    flat = out_buf.reshape(-1, d)
    n = flat.shape[0]
    held = keep
    if first is not None:
        slot = slot - first
        held = keep & (slot >= 0) & (slot < n)
    y_rep = flat[slot.clamp(0, n - 1).reshape(-1)]
    y_rep = torch.where(held.reshape(-1, 1), y_rep, 0)
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


def moe_ffn(params, cfg, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """x: (B, S, d) -> (y, aux) in the layout the active plan selects (the
    module docstring): Z = ``n_data`` routing groups where its mesh is set
    for shard_map, B splits over its data shards and its model axis over
    the experts, or where it asks for hierarchical, Z > 1 splits B and
    each shard has at least ``top_k`` tokens; else the global layout, all
    B*S tokens one routing group."""
    m = cfg.moe
    B, S, _ = x.shape
    plan = mesh_ctx.current()
    Z = plan.n_data
    if plan.moe_impl == "shard_map" and plan.mesh is not None:
        grouped = B % Z == 0 and m.n_routed % plan.n_model == 0
    else:
        # B % Z: a token shard must be whole sequences of one data shard
        grouped = (plan.moe_hierarchical and Z > 1 and B % Z == 0
                   and B * S // Z >= m.top_k)
    if not grouped:
        return _moe_ffn_grouped(params, cfg, x, 1)
    _check_one_process(plan)
    return _moe_ffn_grouped(params, cfg, x, Z)


def _check_one_process(plan) -> None:
    """Raise :class:`~repro_torch.launch.mesh.MeshShapeError` for a plan
    over a mesh of ranks: the layouts compute every data shard in this one
    process, and MoE across ranks comes with the train mesh, ROADMAP item
    1.18.2."""
    from repro_torch.launch.mesh import MeshShapeError, ServeMesh

    if isinstance(plan.mesh, ServeMesh):
        raise MeshShapeError(
            f"the {plan.moe_impl} MoE layout over a mesh of ranks comes "
            f"with the train mesh, ROADMAP item 1.18.2; plan it over a "
            f"MeshShape", shape=(plan.n_data, plan.n_model),
            n_devices=plan.mesh.size)


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
    buf, slot, keep = _dispatch(m, xg, idx.reshape(S, B, m.top_k), C)
    split = mesh is not None and mesh.experts_split
    first = None
    if split:  # this rank's experts: a slice of the buffer's expert axis
        n_loc = params["wi_gate"].shape[0]
        e0 = mesh.mesh.axis_index("model") * n_loc
        buf, first = buf[e0:e0 + n_loc], e0 * S * C
    out_buf = _expert_gemms(params, buf, x.dtype)
    y = _combine(out_buf, slot, keep, gates.reshape(S, B, m.top_k),
                 m.top_k, x.dtype, first).transpose(0, 1)  # (B, S, d)
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
