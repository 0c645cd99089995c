"""Built-in tuning spaces for the registry kernels: the CUDA launch variants.

The reference's spaces (:mod:`repro.tuning.spaces`) search TPU tiles
(``bm/bn/bk``, ``block_rows``, ``block_outer``, ``block_s``, ``block_c``)
against a VMEM budget.  On the card those keywords are only checked: each
CUDA kernel's launch shape is fixed when it is compiled.  So each space
here searches the keywords that name a compiled launch variant, with
today's constants as the defaults (so tuned-vs-default is well defined):

=================  ===============================  =====================
kernel             axes                             default
=================  ===============================  =====================
gemm               tile_m, tile_n, tile_k, stages   the route's own
stream-*           threads, vecs                    256, 4
jacobi2d           tile_h                           8
qc-gate            threads (qubit 0, theta 0.25)    256
flash-decode       split_rows                       256
flash-prefill      q_tile, key_tile                 64, 64
=================  ===============================  =====================

The GEMM's two routes have their own variants and defaults
(:data:`repro_torch.kernels.gemm.kernel.VARIANTS`); the constraint keeps
the variants of the route ``gemm_plan`` picks for the operands' dtype, and
the default (every axis None) resolves to that route's default.  Each
space's ``vmem_model`` is a block's shared memory, from the formulas of
the plan functions, against :data:`~repro_torch.tuning.space.SMEM_LIMIT`;
its ``traffic_model`` the device-memory bytes where the launch shape
changes them (GEMM tile reuse, Jacobi halo rows, decode split partials,
prefill query tiles), and the config-independent bytes elsewhere, where
timing alone decides.

:func:`paged_kv_space` is the reference's, copied: the ``kv_dtype`` axis of
the serve path, registered on no kernel.  SpMV has no space, as in the
reference: its tunable quantities are data-layout parameters fixed at
problem construction.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from repro_torch.tuning.space import SMEM_LIMIT, TuningSpace


def _itemsize(t: Any) -> int:
    return t.dtype.itemsize


def _sum(t: Any) -> float:
    return float(t.sum())


# ---------------------------------------------------------------------------
# GEMM — the two routes' compiled tiles and stages
# ---------------------------------------------------------------------------

#: every route's variants, ordered so that ``subset(2)`` keeps both routes'
#: defaults: wgmma (128, 256, 64, 4) and simt (128, 128, 16, 2)
GEMM_AXES: Dict[str, Tuple[int, ...]] = {
    "tile_m": (128, 64),
    "tile_n": (256, 128, 64),
    "tile_k": (64, 16),
    "stages": (4, 2, 3),
}


def _gemm_plan(cfg: Dict[str, Any], args: Tuple):
    from repro_torch.kernels.gemm import kernel

    x, y = args[0], args[1]
    M, K = x.shape
    return kernel.gemm_plan(M, y.shape[1], K, x.dtype, True,
                            cfg.get("tile_m"), cfg.get("tile_n"),
                            cfg.get("tile_k"), cfg.get("stages"))


def _gemm_clamp(cfg: Dict[str, Any], args: Tuple) -> Dict[str, Any]:
    """Axes left None take the planned route's default variant."""
    if all(cfg.get(k) is not None for k in GEMM_AXES):
        return cfg
    try:
        plan = _gemm_plan(cfg, args)
    except (ValueError, TypeError):
        return cfg
    return dict(zip(GEMM_AXES, (*plan.tile, plan.stages)))


def _gemm_ok(cfg: Dict[str, Any], args: Tuple) -> bool:
    try:
        _gemm_plan(cfg, args)
    except (ValueError, TypeError):
        return False
    return True


def _gemm_smem(cfg: Dict[str, Any], args: Tuple, dtype_bytes: int) -> float:
    try:
        return float(_gemm_plan(cfg, args).smem)
    except (ValueError, TypeError):
        return math.inf


def _gemm_dims(args: Tuple) -> Tuple[int, int, int]:
    x, y = args[0], args[1]
    M, K = x.shape
    return M, y.shape[1], K


def _gemm_traffic(cfg: Dict[str, Any], args: Tuple) -> float:
    """Tile reuse: A is read once per column of tiles (N / tile_n), B once
    per row of tiles (M / tile_m), the output written once."""
    M, N, K = _gemm_dims(args)
    b = _itemsize(args[0])
    col_tiles = -(-N // cfg["tile_n"])
    row_tiles = -(-M // cfg["tile_m"])
    return float(M * K * col_tiles * b + K * N * row_tiles * b + M * N * b)


def _gemm_flops(args: Tuple) -> float:
    M, N, K = _gemm_dims(args)
    return 2.0 * M * N * K


def gemm_space() -> TuningSpace:
    return TuningSpace(
        kernel="gemm",
        axes=dict(GEMM_AXES),
        default=dict.fromkeys(GEMM_AXES),  # the route's default variant
        dtypes=("fp32", "bf16"),
        clamp=_gemm_clamp,
        constraint=_gemm_ok,
        vmem_model=_gemm_smem,
        traffic_model=_gemm_traffic,
        flops_model=_gemm_flops,
    )


def pick_gemm_tiles(M: int, N: int, K: int, dtype: Any, *,
                    smem_budget: int = SMEM_LIMIT) -> Tuple[int, ...]:
    """The largest-volume compiled variant (tile_m, tile_n, tile_k, stages)
    of the route ``gemm_plan`` picks for ``dtype`` whose tile lies inside
    (M, N, K) and whose block fits ``smem_budget`` bytes of shared memory;
    the route's default when none does.  The first listed wins ties.  This
    is the port's projection of its GEMM space, as the reference's
    ``pick_gemm_tiles`` is of its own."""
    from repro_torch.kernels.gemm import kernel

    route = kernel.gemm_plan(M, N, K, dtype).route
    best, best_volume = kernel.VARIANTS[route][0], 0
    for v in kernel.VARIANTS[route]:
        tm, tn, tk, _ = v
        if tm > M or tn > N or tk > K:
            continue
        if kernel.gemm_plan(M, N, K, dtype, True, *v).smem > smem_budget:
            continue
        if tm * tn * tk > best_volume:
            best, best_volume = v, tm * tn * tk
    return best


# ---------------------------------------------------------------------------
# STREAM — threads a block x vectors a thread; traffic is config-independent
# ---------------------------------------------------------------------------


def stream_space(n_arrays: int, flops_per_elem: float) -> TuningSpace:
    def traffic(cfg: Dict[str, Any], args: Tuple) -> float:
        a = args[0]
        return float((n_arrays + 1) * a.numel() * _itemsize(a))

    def flops(args: Tuple) -> float:
        return flops_per_elem * args[0].numel()

    return TuningSpace(
        kernel="stream",
        axes={"threads": (256, 128, 512), "vecs": (4, 2, 8)},
        default={"threads": 256, "vecs": 4},
        dtypes=("fp32", "bf16", "fp16"),
        traffic_model=traffic,
        flops_model=flops,
    )


# ---------------------------------------------------------------------------
# Jacobi2D — block height trades halo re-reads
# ---------------------------------------------------------------------------


def _jacobi_traffic(cfg: Dict[str, Any], args: Tuple) -> float:
    """A 32 x tile_h block reads its rows and one halo row above and below
    that its neighbours also read: H * W * b * (1 + 2 / tile_h) bytes read,
    H * W * b written."""
    H, W = args[0].shape
    b = _itemsize(args[0])
    return float(H * W * b * (1.0 + 2.0 / cfg["tile_h"]) + H * W * b)


def jacobi2d_space() -> TuningSpace:
    return TuningSpace(
        kernel="jacobi2d",
        axes={"tile_h": (8, 4, 16, 32)},
        default={"tile_h": 8},
        dtypes=("fp32",),
        traffic_model=_jacobi_traffic,
        flops_model=lambda args: 4.0 * args[0].shape[0] * args[0].shape[1],
    )


# ---------------------------------------------------------------------------
# QC RX gate — threads a block; traffic is config-independent
# ---------------------------------------------------------------------------


def qc_gate_space() -> TuningSpace:
    return TuningSpace(
        kernel="qc-gate",
        axes={"threads": (256, 128, 512, 1024)},
        default={"threads": 256},
        dtypes=("fp32",),
        fixed={"qubit": 0, "theta": 0.25},
        traffic_model=lambda cfg, args: float(
            4 * args[0].shape[0] * _itemsize(args[0])),
        flops_model=lambda args: 6.0 * args[0].shape[0],
    )


# ---------------------------------------------------------------------------
# Flash-decode (contiguous) — rows a split walks
# ---------------------------------------------------------------------------
#
# args convention = the kernel call: (q (B, KV, G, D), k (B, S, KV, D), v,
# valid_len (B,)).

#: the decode's ``split_rows`` axis, default first
FD_SPLITS: Tuple[int, ...] = (256, 128, 512, 1024, 2048)


def _fd_clamp(cfg: Dict[str, Any], args: Tuple) -> Dict[str, Any]:
    """Splits of S rows or more are one split, the same launch whatever
    their length: they collapse onto the default when it covers S, else onto
    the smallest axis value that does.  A config stays an axis value, so one
    tuned at a short cache and resolved at a longer one is a launch shape
    the space offers."""
    S = args[1].shape[1]
    rows = cfg["split_rows"]
    if rows >= S:
        rows = (FD_SPLITS[0] if FD_SPLITS[0] >= S
                else min(r for r in FD_SPLITS if r >= S))
    return {"split_rows": rows}


def _fd_traffic(cfg: Dict[str, Any], args: Tuple) -> float:
    """K and V once, q read and the output written once, and with more than
    one split each (slot, query head, split)'s partial of D + 2 floats
    written and read back by the merge."""
    q, k = args[0], args[1]
    b = _itemsize(q)
    B, KV, G, D = q.shape
    S = k.shape[1]
    splits = -(-S // cfg["split_rows"])
    partials = 2 * B * KV * G * splits * (D + 2) * 4 if splits > 1 else 0
    return float((2 * B * S * KV * D + 2 * B * KV * G * D) * b + partials)


def flash_decode_space() -> TuningSpace:
    return TuningSpace(
        kernel="flash-decode",
        axes={"split_rows": FD_SPLITS},
        default={"split_rows": FD_SPLITS[0]},
        dtypes=("fp32", "bf16"),
        clamp=_fd_clamp,
        traffic_model=_fd_traffic,
        flops_model=lambda args: 4.0
        * args[0].shape[0] * args[0].shape[1] * args[0].shape[2]
        * args[0].shape[3] * args[1].shape[1],
    )


# ---------------------------------------------------------------------------
# Flash-prefill — query vectors a block x key rows a tile
# ---------------------------------------------------------------------------
#
# args convention = the kernel call: (q (B,C,KV,G,D), k_new, v_new,
# k_pool (n_blocks,bs,KV,D), v_pool, block_tables (B,nb), q_start (B,)).


def _fp_dims(args: Tuple) -> Tuple[int, int, int, int, int, int, int]:
    q, k_pool, bt = args[0], args[3], args[5]
    B, C, KV, G, D = q.shape
    return B, C, KV, G, D, k_pool.shape[1], bt.shape[1]


def _fp_plan(cfg: Dict[str, Any], args: Tuple):
    from repro_torch.kernels.flash_decode import kernel

    _, C, _, G, D, bs, nb = _fp_dims(args)
    if D not in kernel.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {kernel.HEAD_DIMS}")
    return kernel.prefill_plan(C, G, D, bs, nb, args[0].dtype,
                               args[3].dtype, cfg["q_tile"], cfg["key_tile"])


def _fp_ok(cfg: Dict[str, Any], args: Tuple) -> bool:
    try:
        _fp_plan(cfg, args)
    except (ValueError, TypeError):
        return False
    return True


def _fp_smem(cfg: Dict[str, Any], args: Tuple, dtype_bytes: int) -> float:
    try:
        return float(_fp_plan(cfg, args).smem)
    except (ValueError, TypeError):
        return math.inf


def _fp_live(args: Tuple) -> float:
    """Mean causal frontier per chunk row: context plus half the chunk."""
    _, C, _, _, _, _, _ = _fp_dims(args)
    return float(args[6].double().mean()) + (C + 1) / 2.0


def _fp_traffic(cfg: Dict[str, Any], args: Tuple) -> float:
    """The reference's model with a block's chunk rows as the query tile
    (``q_tile // G`` of them, at most C): every query tile re-streams its
    causal KV prefix, and the chunk's commit is written once."""
    B, C, KV, G, D, _, _ = _fp_dims(args)
    b = _itemsize(args[0])
    rows = max(1, min(C, cfg["q_tile"] // G))
    nq = -(-C // rows)
    live = _fp_live(args)
    return float(
        2 * B * KV * nq * live * D * b      # K+V streamed per query tile
        + 3 * B * C * KV * D * b            # chunk K/V read + committed
        + 2 * B * C * KV * G * D * b        # q read + out written
    )


def _fp_flops(args: Tuple) -> float:
    B, C, KV, G, D, _, _ = _fp_dims(args)
    return 4.0 * KV * G * D * B * C * _fp_live(args)


def flash_prefill_space() -> TuningSpace:
    return TuningSpace(
        kernel="flash-prefill",
        axes={"q_tile": (64, 32), "key_tile": (64, 32)},
        default={"q_tile": 64, "key_tile": 64},
        dtypes=("fp32", "bf16"),
        constraint=_fp_ok,
        vmem_model=_fp_smem,
        traffic_model=_fp_traffic,
        flops_model=_fp_flops,
    )


# ---------------------------------------------------------------------------
# Paged-KV storage dtype — the ELEN axis of the serve-path block pool
# ---------------------------------------------------------------------------
#
# args convention = the paged decode call: (q (B,KV,G,D),
# k_pool (n_blocks,bs,KV,D), v_pool, block_tables (B,nb), valid_len (B,)).
#
# Unlike the per-kernel ``dtypes`` tuple (which casts the COMPUTE operands,
# paper Eq. 1 applied to the arithmetic), ``kv_dtype`` narrows only the
# STORED cache: queries and the softmax stay at the compute dtype while
# each KV row is read at 1/2 (bf16) or 1/4 (int8, plus one fp32 scale per
# row) of the f32 bytes and widened on chip.  The tuner must therefore
# never cast the example operands for this axis — it is a distinct static
# argument of the serve path (``ServeEngine(kv_dtype=...)``), searched by
# the accuracy-vs-speed sweep, not by operand substitution.

#: Pool bytes per stored element for each kv_dtype candidate.
KV_DTYPE_ITEMSIZE: Dict[str, int] = {"f32": 4, "bf16": 2, "int8": 1}


def _kv_dims(args: Tuple) -> Tuple[int, int, int, int, int]:
    q, k_pool = args[0], args[1]
    B, KV, G, D = q.shape
    return B, KV, G, D, k_pool.shape[1]


def _kv_traffic(cfg: Dict[str, Any], args: Tuple) -> float:
    """Decode-step traffic: live K+V rows stream at the pool itemsize
    (int8 adds the two fp32 scale rows per block); q/out traffic is at the
    compute dtype and independent of the axis."""
    B, KV, G, D, bs = _kv_dims(args)
    kv_dtype = cfg["kv_dtype"]
    item = KV_DTYPE_ITEMSIZE[kv_dtype]
    live = _sum(args[4])
    kv_bytes = 2.0 * live * KV * D * item
    if kv_dtype == "int8":
        kv_bytes += 2.0 * live * 4.0  # per-row fp32 scales
    q_bytes = 2.0 * B * KV * G * D * _itemsize(args[0])
    return kv_bytes + q_bytes


def _kv_vmem(cfg: Dict[str, Any], args: Tuple, dtype_bytes: int) -> float:
    """One pool block of K+V at the storage dtype, widened tile + q + acc
    at fp32 (both copies resident)."""
    _, _, G, D, bs = _kv_dims(args)
    item = KV_DTYPE_ITEMSIZE[cfg["kv_dtype"]]
    return float(2 * bs * D * (item + 4) + 2 * G * D * 4)


def _kv_flops(args: Tuple) -> float:
    _, KV, G, D, _ = _kv_dims(args)
    return 4.0 * KV * G * D * _sum(args[4])


def paged_kv_space() -> TuningSpace:
    """The ``kv_dtype`` axis of the paged serve path (quantized paging).

    Candidates are ordered widest-first so ``subset(1)`` (the CI tiny-space
    knob) keeps the exact f32 baseline.  ``dtypes`` is deliberately empty:
    the axis is a static serve-path argument, not an operand cast."""
    return TuningSpace(
        kernel="paged-kv",
        axes={"kv_dtype": ("f32", "bf16", "int8")},
        default={"kv_dtype": "f32"},
        dtypes=(),
        vmem_model=_kv_vmem,
        traffic_model=_kv_traffic,
        flops_model=_kv_flops,
    )
