"""Mamba-2 mixer (SSD, state-space duality, arXiv:2405.21060).

Port of ``repro/models/ssm.py``: ``init_mamba``, ``mamba_full`` (the
chunked SSD forward, which the train path differentiates through its
torch ops), ``init_mamba_cache`` and
``mamba_decode`` (the one-token recurrence ``S <- exp(dt*A) S + dt * B (x)
x``, read out as ``y = C . S + D x``), with the reference's parameter names
and layouts, so its sharding rules and parameter trees apply unchanged.

The serve path's chunk step is :func:`mamba_chunk`: a chunk of ``w`` rows
per slot in the SSD dual form of ``mamba_full``'s chunk body, started from
each slot's recurrent state, where the reference scans its one-token cell
over the chunk.  The two agree within the reference's own bound for these
two orders (``tests/test_ssm.py``).  Rows past a slot's length move neither
state: their ``dt`` is 0, so their decay is exactly 1 and their update
exactly 0, and the conv window ends at the slot's last real row.

State math is fp32 whatever the compute dtype (long products of decays
underflow bf16); the conv window stays in the compute dtype.  The
reference's ``jax.nn.softplus`` is ``logaddexp(x, 0)``, which
``torch.nn.functional.softplus`` (linear above its threshold) is not, so
the port takes ``torch.logaddexp``.

Tensor parallelism: under a :class:`~repro_torch.models.layers.MeshContext`
whose rules split the mixer over ``model`` (``mamba_split``), this rank's
``wz``/``wx``/``wdt`` columns and ``conv_x_*`` channels are its heads', the
whole-width vectors (``A_log``, ``D``, ``dt_bias`` and the gated norm's
scale) are indexed by those heads or channels, ``wBC`` and ``conv_BC_*``
are whole, the gated RMS norm sums its squares over ``model`` in fp32 and
``out_proj`` is row-parallel.  Such a
rank's ``ssm_state`` holds its heads, and its ``conv_state`` (the
``d_conv - 1`` last pre-conv rows) holds its ``x`` channels and its
``1/M`` share of the ``B``/``C`` channels, ``conv_ch / M`` in all; the
``B``/``C`` window is gathered over ``model`` before the conv, since
every head reads all of it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.layers import MeshContext


def _dims(cfg):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return s, d, di, nh, conv_ch


def init_mamba(gen: torch.Generator, cfg, dtype, device) -> dict:
    """The reference's separate projections ``wz``/``wx``/``wBC``/``wdt``
    (so each shards by its own rule), the depthwise conv taps of the x and
    B/C channels, ``A_log``/``D``/``dt_bias`` (fp32), the gated norm and
    ``out_proj``.  Every matrix is drawn from a generator of its own,
    seeded from ``gen``, in parallel threads
    (:func:`~repro_torch.models.layers.truncated_normal_many`)."""
    s, d, di, nh, _ = _dims(cfg)
    gn2 = 2 * s.n_groups * s.d_state
    names = ("wz", "wx", "wBC", "wdt", "conv_x_w", "conv_BC_w", "out_proj")
    shapes = ((d, di), (d, di), (d, gn2), (d, nh), (s.d_conv, di),
              (s.d_conv, gn2), (di, d))
    w = dict(zip(names, layers.truncated_normal_many(gen, shapes, 1.0, dtype,
                                                     device)))
    return {
        "wz": {"w": w["wz"]},
        "wx": {"w": w["wx"]},
        "wBC": {"w": w["wBC"]},
        "wdt": {"w": w["wdt"]},
        "conv_x_w": w["conv_x_w"],
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=device),
        "conv_BC_w": w["conv_BC_w"],
        "conv_BC_b": torch.zeros((gn2,), dtype=dtype, device=device),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=device),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "norm": layers.rms_norm_init(di, dtype, device),
        "out_proj": {"w": w["out_proj"]},
    }


def _split(mesh: Optional[MeshContext]) -> bool:
    return mesh is not None and mesh.mamba_split


def _own(v: torch.Tensor, n_local: int, mesh: Optional[MeshContext]
         ) -> torch.Tensor:
    """This rank's ``n_local`` entries of a whole-width vector (its heads
    or channels; the rules replicate these vectors) under a model split,
    else ``v``."""
    if not _split(mesh):
        return v
    i = mesh.mesh.axis_index("model")
    return mesh.copy(v)[i * n_local:(i + 1) * n_local]


def _project_in(params, cfg, x):
    """x (B,S,d) -> z (B,S,di), xBC (B,S,di+2GN) pre-conv, dt (B,S,nh);
    under a model split, this rank's z, x and dt columns and all of B/C."""
    z = layers.dense(params["wz"], x)
    xs = layers.dense(params["wx"], x)
    bc = layers.dense(params["wBC"], x)
    dt = layers.dense(params["wdt"], x)
    return z, torch.cat([xs, bc], dim=-1), dt


def _conv_w_b(params):
    """The conv taps (d_conv, ch) and bias (ch,) of the x then B/C
    channels (this rank's x channels under a model split)."""
    w = torch.cat([params["conv_x_w"], params["conv_BC_w"]], dim=-1)
    b = torch.cat([params["conv_x_b"], params["conv_BC_b"]], dim=-1)
    return w, b


def _window_conv(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv of the rows that follow a window's first
    ``d_conv - 1``: ``window`` (B, d_conv - 1 + S, ch) -> (B, S, ch), the
    d_conv taps as shifted adds."""
    k = w.shape[0] - 1
    S = window.shape[1] - k
    out = sum(window[:, i:i + S] * w[i].to(window.dtype) for i in range(k + 1))
    return F.silu(out + b.to(window.dtype))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no linear branch."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gated_out(params, cfg, y_flat, z, mesh: Optional[MeshContext] = None):
    """RMS norm over all of d_inner of ``y * silu(z)``, then ``out_proj``;
    under a model split the squares are summed over ``model`` in fp32 and
    ``out_proj`` is row-parallel."""
    g = y_flat * F.silu(z)
    if not _split(mesh):
        return layers.dense(params["out_proj"],
                            layers.rms_norm(params["norm"], g, cfg.norm_eps))
    g32 = g.float()
    di = cfg.ssm.d_inner(cfg.d_model)
    # the whole sum of squares enters every rank's channels
    ss = mesh.copy(mesh.mesh.sum(g32.square().sum(dim=-1, keepdim=True),
                                 "model"))
    y = g32 * torch.rsqrt(ss / di + cfg.norm_eps)
    y = (y * _own(params["norm"]["scale"], g.shape[-1], mesh).float()
         ).to(g.dtype)
    return layers.row_parallel(y @ params["out_proj"]["w"].to(y.dtype),
                               mesh.mesh)


def _heads(params, cfg, xc: torch.Tensor, dt: torch.Tensor,
           mesh: Optional[MeshContext] = None):
    """Split conv outputs (..., ch) into x (..., nh, P), B and C (..., G,
    N), and make dt (..., nh) fp32 through softplus; A (nh,) fp32.  All
    of this rank's heads under a model split."""
    s = cfg.ssm
    G, N, P = s.n_groups, s.d_state, s.head_dim
    di = xc.shape[-1] - 2 * G * N
    nh = di // P
    lead = xc.shape[:-1]
    xs = xc[..., :di].reshape(*lead, nh, P)
    Bm = xc[..., di:di + G * N].reshape(*lead, G, N)
    Cm = xc[..., di + G * N:].reshape(*lead, G, N)
    dt = _softplus(dt.float() + _own(params["dt_bias"], nh, mesh))
    A = -torch.exp(_own(params["A_log"], nh, mesh))
    return xs, Bm, Cm, dt, A, _own(params["D"], nh, mesh)


def _ssd_chunk(x_c, B_c, C_c, dt_c, A, D, S_prev):
    """One SSD chunk in the dual form: the intra-chunk decay-weighted
    contraction plus the read of the incoming state, and the chunk-final
    state.  x_c (B,Q,nh,P); B_c, C_c (B,Q,G,N); dt_c (B,Q,nh) fp32; A, D
    (nh,); S_prev (B,nh,N,P) fp32.  Returns y (B,Q,nh,P) fp32 and S_new."""
    Bsz, Q, nh, P = x_c.shape
    G = B_c.shape[2]
    hpg = nh // G
    dA = dt_c * A  # (B,Q,nh)
    cum = torch.cumsum(dA, dim=1)
    total = cum[:, -1]  # (B,nh)
    xf = x_c.float()
    Bf, Cf = B_c.float(), C_c.float()

    # intra-chunk: M[q,j] = (C_q.B_j) exp(cum_q - cum_j) dt_j,  j <= q
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x_c.device).tril()
    decay = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Q,Q,nh)
    decay = decay.masked_fill(~tri[None, :, :, None], float("-inf"))
    cb = torch.einsum("bqgn,bjgn->bqjg", Cf, Bf)
    cb = cb.repeat_interleave(hpg, dim=3)  # (B,Q,Q,nh)
    M = cb * torch.exp(decay) * dt_c[:, None, :, :]
    y = torch.einsum("bqjh,bjhp->bqhp", M, xf)

    # inter-chunk: y_q += C_q . (exp(cum_q) * S_prev)
    Ch = Cf.repeat_interleave(hpg, dim=2)  # (B,Q,nh,N)
    y = y + torch.einsum("bqhn,bhnp->bqhp", Ch * torch.exp(cum)[..., None],
                         S_prev)
    y = y + D[None, None, :, None] * xf

    # chunk-final local state + state passing
    w = torch.exp(total[:, None, :] - cum) * dt_c  # (B,Q,nh)
    wx = (w[..., None] * xf).reshape(Bsz, Q, G, hpg, P)
    S_local = torch.einsum("bqgn,bqgkp->bgknp", Bf, wx).reshape(
        Bsz, nh, Bf.shape[-1], P)
    S_new = torch.exp(total)[:, :, None, None] * S_prev + S_local
    return y, S_new


def mamba_full(params, cfg, x: torch.Tensor, *,
               initial_state: Optional[torch.Tensor] = None,
               return_state: bool = False,
               mesh: Optional[MeshContext] = None):
    """Chunked SSD forward, differentiable (no op writes in place into a
    tensor autograd saves).  x: (B, S, d) -> (B, S, d) [, final state (B,
    nh, N, P) fp32].  Under a train step's ``mesh`` whose rules split the
    mixer, on this rank's heads and channels: ``wBC`` and the B/C conv run
    whole, and their output enters the heads through
    :meth:`~MeshContext.copy`."""
    s, d, di, nh, _ = _dims(cfg)
    Bsz, S, _ = x.shape
    Q = min(s.chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    split = _split(mesh)

    if split:  # x enters the column-parallel wz/wx/wdt
        xs = mesh.copy(x)
        z, dt = layers.dense(params["wz"], xs), layers.dense(params["wdt"],
                                                             xs)
        xBC = torch.cat([layers.dense(params["wx"], xs),
                         layers.dense(params["wBC"], x)], dim=-1)
    else:
        z, xBC, dt = _project_in(params, cfg, x)
    cw, cb = _conv_w_b(params)
    xBC = _window_conv(F.pad(xBC, (0, 0, cw.shape[0] - 1, 0)), cw, cb)
    if split:
        di_l = params["conv_x_w"].shape[-1]
        xBC = torch.cat([xBC[..., :di_l], mesh.copy(xBC[..., di_l:])],
                        dim=-1)
    xs, Bm, Cm, dt, A, D = _heads(params, cfg, xBC, dt, mesh)
    nh = xs.shape[-2]
    if pad:
        xs, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))

    S_state = (initial_state.float() if initial_state is not None
               else torch.zeros((Bsz, nh, s.d_state, s.head_dim),
                                dtype=torch.float32, device=x.device))
    ys = []
    for c in range(nc):
        rows = slice(c * Q, (c + 1) * Q)
        y_c, S_state = _ssd_chunk(xs[:, rows], Bm[:, rows], Cm[:, rows],
                                  dt[:, rows], A, D, S_state)
        ys.append(y_c)
    y = torch.cat(ys, dim=1).reshape(Bsz, nc * Q, -1)[:, :S].to(x.dtype)
    out = _gated_out(params, cfg, y, z, mesh)
    if return_state:
        return out, S_state
    return out


def cache_shapes(cfg, batch: int, layers_stacked: int, dtype) -> dict:
    """(shape, dtype) of each recurrent-state leaf: ``ssm_state``
    (layers, B, nh, N, P) fp32 and ``conv_state`` (layers, B, d_conv - 1,
    conv_ch) in ``dtype``."""
    s, _, _, nh, conv_ch = _dims(cfg)
    return {"ssm_state": ((layers_stacked, batch, nh, s.d_state,
                           s.head_dim), torch.float32),
            "conv_state": ((layers_stacked, batch, s.d_conv - 1, conv_ch),
                           dtype)}


def init_mamba_cache(cfg, batch: int, dtype, layers_stacked: int = 1,
                     device="cuda") -> dict:
    """Zeroed recurrent state, by :func:`cache_shapes`, on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    return {key: torch.zeros(shape, dtype=dt, device=dev)
            for key, (shape, dt) in cache_shapes(cfg, batch, layers_stacked,
                                                  dtype).items()}


def _bc_window(conv_state: torch.Tensor, di_local: int,
               mesh: Optional[MeshContext]) -> torch.Tensor:
    """A conv window as this rank's mixer reads it: under a model split
    its x channels and all of B/C (each rank stores a share of the B/C
    window, gathered here over ``model``); else the window itself."""
    if not _split(mesh):
        return conv_state
    return torch.cat([conv_state[..., :di_local],
                      mesh.mesh.gather(conv_state[..., di_local:], "model",
                                       dim=-1)], dim=-1)


def _stored_window(window: torch.Tensor, di_local: int,
                   mesh: Optional[MeshContext]) -> torch.Tensor:
    """The conv window as this rank stores it: under a model split its x
    channels and its share of the B/C channels."""
    if not _split(mesh):
        return window
    bc = window[..., di_local:]
    per = bc.shape[-1] // mesh.mesh.axis_size("model")
    i = mesh.mesh.axis_index("model")
    return torch.cat([window[..., :di_local],
                      bc[..., i * per:(i + 1) * per]], dim=-1)


def mamba_decode(params, cfg, x: torch.Tensor, ssm_state: torch.Tensor,
                 conv_state: torch.Tensor,
                 mesh: Optional[MeshContext] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step.  x: (B,1,d); ssm_state: (B,nh,N,P) fp32;
    conv_state: (B, d_conv-1, conv_ch).  Returns (y (B,1,d), ssm_state,
    conv_state), the states new tensors."""
    Bsz = x.shape[0]
    z, xBC, dt = _project_in(params, cfg, x)
    di_local = z.shape[-1]
    cw, cb = _conv_w_b(params)
    window = torch.cat([_bc_window(conv_state, di_local, mesh),
                        xBC[:, 0:1, :]], dim=1)  # (B,d_conv,ch)
    conv_out = torch.einsum("btc,tc->bc", window, cw.to(x.dtype))
    conv_out = F.silu(conv_out + cb.to(x.dtype))
    xs, Bm, Cm, dt, A, D = _heads(params, cfg, conv_out, dt[:, 0], mesh)
    hpg = xs.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(hpg, dim=1).float()  # (B,nh,N)
    Ch = Cm.repeat_interleave(hpg, dim=1).float()
    decay = torch.exp(dt * A)  # (B,nh)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh, xs.float())
    S_new = decay[:, :, None, None] * ssm_state + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, S_new)
    y = y + D[None, :, None] * xs.float()
    y = y.reshape(Bsz, 1, di_local).to(x.dtype)
    out = _gated_out(params, cfg, y, z, mesh)
    return out, S_new, _stored_window(window[:, 1:], di_local, mesh)


def mamba_chunk(params, cfg, x: torch.Tensor, ssm_state: torch.Tensor,
                conv_state: torch.Tensor, lengths: torch.Tensor,
                mesh: Optional[MeshContext] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A chunk of ``w`` rows per slot in the SSD dual form, from each
    slot's state.

    x (B, w, d); ssm_state (B, nh, N, P) fp32; conv_state (B, d_conv-1,
    conv_ch); lengths (B,) int in [0, w], slot ``b``'s real rows.  The
    causal conv runs over ``[conv_state; rows]``, and the chunk is one
    :func:`_ssd_chunk` from ``ssm_state`` with ``dt`` 0 on rows past
    ``lengths[b]``.  Returns (y (B, w, d), ssm_state, conv_state), the
    states new tensors: the state after the slot's real rows, and the
    window of the ``d_conv - 1`` rows ending at its last real row (the
    old window where ``lengths[b]`` is 0).  Rows past ``lengths[b]`` give
    finite, meaningless outputs and move neither state.
    """
    Bsz, w, _ = x.shape
    lengths = lengths.to(x.device).long()
    z, xBC, dt = _project_in(params, cfg, x)
    di_local = z.shape[-1]
    cw, cb = _conv_w_b(params)
    k = cw.shape[0] - 1
    window = torch.cat([_bc_window(conv_state, di_local, mesh), xBC],
                       dim=1)  # (B, k + w, ch)
    conv = _window_conv(window, cw, cb)
    xs, Bm, Cm, dt, A, D = _heads(params, cfg, conv, dt, mesh)
    live = torch.arange(w, device=x.device)[None, :] < lengths[:, None]
    dt = torch.where(live[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                      device=dt.device))
    y, S_new = _ssd_chunk(xs, Bm, Cm, dt, A, D, ssm_state.float())
    y = y.reshape(Bsz, w, di_local).to(x.dtype)
    out = _gated_out(params, cfg, y, z, mesh)
    # the window's k rows ending at row lengths[b] - 1: rows [len, len + k)
    rows = lengths[:, None] + torch.arange(k, device=x.device)[None, :]
    tail = window.gather(1, rows[..., None].expand(Bsz, k, window.shape[-1]))
    return out, S_new, _stored_window(tail, di_local, mesh)
