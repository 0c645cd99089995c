"""Flash-decode (paged and contiguous) and chunked prefill: the wrappers of
the CUDA kernels in ``csrc/``.

Both CUDA sources are built and loaded at first use by
:mod:`repro_torch.kernels.build`, into ``build/`` beside ``csrc/``.

:func:`flash_decode_paged`, :func:`flash_decode`,
:func:`flash_prefill_paged` and :func:`commit_paged` take CPU tensors to
their plain versions in ``ref.py`` and launch their kernels for CUDA
tensors; there is no fallback from one to the other, and a (q, pool) dtype
pair outside :data:`POOL_PAIRS` raises.  The paged kernels take pools in
q's dtype, bf16 pools under an f32 q, and int8 pools with one fp32 scale a
pool row.  Each wrapper's ``launches`` attribute counts the calls that
launched its kernels.  :func:`flash_decode_paged` takes the reference's
``head_shard=(i, n)`` (one shard's 1/n of the KV heads, read in place from
the full pools) and, with ``k_new``/``v_new``, commits each slot's new row
in the same launch before it attends (a decode step's commit and attention
in one kernel); :func:`flash_decode_paged_sharded` is the reference's
tensor-parallel decode: each rank of a mesh's model axis runs the decode
kernel on its local heads.  The commits take each row's amax over all KV
heads (``k_amax``/``v_amax``) from a caller whose pools hold only some of
them.  :func:`flash_decode` and :func:`flash_prefill` take the reference's
argument lists and check its tile arguments (``block_s``, ``block_c``) as
it does; the CUDA kernels' tiles are their own, planned on the host from
the shapes alone: :func:`decode_plan` splits each slot's rows across blocks
(the split partials live in scratch kept per device and stream), and
:func:`prefill_plan` sizes the attention's tiles and shared memory.
``*_plain`` are the same functions, with the same checks, in plain PyTorch
on any device.

Launch variants, the tuner's space (:mod:`repro_torch.tuning.spaces`):
:func:`flash_decode` takes ``split_rows``, the rows a split walks (any
positive multiple of :data:`DECODE_TILE`: it is a launch argument), and
:func:`flash_prefill_paged` and :func:`flash_prefill` take ``q_tile`` and
``key_tile``, the query vectors a block and the key rows a tile the
attention is compiled for (:data:`PREFILL_TILES`; the default in
``csrc/flash_prefill_paged.cu`` for every pair, the others in
``csrc/flash_prefill_variants.cu`` for :data:`VARIANT_PAIRS` only).  A
value no variant covers raises on every device.  The defaults are the
constants the serve path runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: (q dtype, pool dtype) pairs the paged kernels are instantiated for: pools
#: in q's dtype, bf16 under an f32 q, and int8 (with per-row fp32 scales)
#: under either
POOL_PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
              (torch.float32, torch.int8), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.int8))
#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: shared memory a block of an H100 may use, with the opt-in attribute
SMEM_LIMIT = 232448
#: rows of the contiguous cache a decode split is made of whole multiples of
DECODE_TILE = 64
#: rows a decode split walks, rounded down to whole pool blocks (or tiles)
DECODE_SPLIT = 256
#: query vectors (chunk rows x G) a prefill attention block takes, at most
PREFILL_VECTORS = 64
#: key rows a prefill attention tile stages, at most
PREFILL_KEYS = 64
#: the compiled (q_tile, key_tile) variants of the prefill attention, the
#: default first
PREFILL_TILES = ((PREFILL_VECTORS, PREFILL_KEYS), (64, 32), (32, 64),
                 (32, 32))
#: (q, pool) dtype pairs the prefill variants other than the default are
#: compiled for
VARIANT_PAIRS = ((torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16))

_P = ctypes.c_void_p
_I = ctypes.c_int
#: (library, C function) -> argument types
_ARGTYPES: Dict[tuple, list] = {
    ("flash_decode_paged", "flash_decode_paged_launch"):
        [_P] * 14 + [_I] * 12 + [_P],
    ("flash_decode_paged", "flash_decode_launch"):
        [_P] * 7 + [_I] * 8 + [_P],
    ("flash_prefill_paged", "flash_prefill_paged_launch"):
        [_P] * 13 + [_I] * 13 + [_P],
    ("flash_prefill_variants", "flash_prefill_variant_launch"):
        [_P] * 13 + [_I] * 15 + [_P],
    ("flash_prefill_paged", "flash_commit_paged_launch"):
        [_P] * 11 + [_I] * 9 + [_P],
}


def _launcher(library: str, symbol: str):
    return build.function(library, symbol, _ARGTYPES[library, symbol])


def _ptr(t) -> int:
    """Device address of ``t``, or 0 (NULL) for None."""
    return 0 if t is None else t.data_ptr()


def _check_head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")


class DecodePlan(NamedTuple):
    """How a decode launch splits each slot's rows: ``splits`` splits of
    ``split_rows`` rows (the last one short), and the scratch the merge
    needs when there is more than one: ``scratch_floats`` partials and
    ``counters`` ints."""

    split_rows: int
    splits: int
    scratch_floats: int
    counters: int


def check_split(split: int) -> None:
    """Raise unless ``split`` is a positive multiple of
    :data:`DECODE_TILE`, the decode's ``split_rows`` launch variants."""
    if split < DECODE_TILE or split % DECODE_TILE:
        raise ValueError(f"split_rows {split} is not a positive multiple "
                         f"of {DECODE_TILE}")


def decode_split_rows(unit: int, split: int = DECODE_SPLIT) -> int:
    """Rows a decode split walks: the largest multiple of ``unit`` (the
    pool's block size, or :data:`DECODE_TILE` for the contiguous cache)
    not above ``split``, and at least one ``unit``."""
    return unit * max(1, split // unit)


@functools.lru_cache(maxsize=256)
def decode_plan(rows: int, unit: int, B: int, KV: int, G: int,
                D: int, split: int = DECODE_SPLIT) -> DecodePlan:
    """The decode kernel's split of ``rows`` rows a slot (``nb * bs``
    paged, ``S`` contiguous) into splits of :func:`decode_split_rows` of
    ``unit`` and ``split``, from the shapes alone: the split boundaries
    depend on ``rows``, ``unit`` and ``split`` only, never on KV, a head
    offset or B, so a head slice's launch splits its rows as the unsharded
    launch does.  With more than one split each (slot, query head, split)
    keeps a partial of D + 2 floats and each (slot, query head) a counter.
    Raises on a ``split`` :func:`check_split` refuses."""
    check_split(split)
    split = decode_split_rows(unit, split)
    splits = max(1, -(-rows // split))
    if splits == 1:
        return DecodePlan(split, 1, 0, 0)
    return DecodePlan(split, splits, B * KV * G * splits * (D + 2),
                      B * KV * G)


#: (device index, stream handle) -> (partials, counters), grown by powers
#: of two; the counters are zero between launches
_SCRATCH: Dict[tuple, tuple] = {}
#: (device index, stream handle, rows, unit, B, KV, G, D) -> (split rows,
#: partials address, counters address) of a decode launch: one lookup a
#: call, emptied whenever a scratch is replaced
_DECODE_ARGS: Dict[tuple, tuple] = {}


def _size_class(n: int) -> int:
    return 1 << max(12, (n - 1).bit_length())


def _decode_scratch(device: torch.device, stream: int, plan: DecodePlan):
    """(partials, counters) addresses for ``plan`` on ``device`` and
    ``stream``, or (0, 0) when it needs none.  The scratch is kept per
    device and stream, and replaced only by one of a larger size class:
    a call allocates nothing in the steady state.  Launches on one stream
    run in order, so they share it safely."""
    if plan.splits == 1:
        return 0, 0
    key = (device.index or 0, stream)
    have = _SCRATCH.get(key)
    if (have is None or have[2] < plan.scratch_floats
            or have[3] < plan.counters):
        floats = _size_class(max(plan.scratch_floats,
                                 have[2] if have else 0))
        counts = _size_class(max(plan.counters, have[3] if have else 0))
        partial = torch.empty(floats, dtype=torch.float32, device=device)
        counters = torch.zeros(counts, dtype=torch.int32, device=device)
        have = (partial.data_ptr(), counters.data_ptr(), floats, counts,
                partial, counters)
        _SCRATCH[key] = have
        _DECODE_ARGS.clear()  # their addresses may be the old scratch's
    return have[0], have[1]


def _decode_args(device: torch.device, key: tuple) -> tuple:
    """(split rows, partials, counters) of a decode launch keyed as
    :data:`_DECODE_ARGS` is; the wrappers look there first."""
    args = _DECODE_ARGS.get(key)
    if args is None:
        plan = decode_plan(*key[2:])
        args = (plan.split_rows, *_decode_scratch(device, key[1], plan))
        if len(_DECODE_ARGS) >= 256:
            _DECODE_ARGS.clear()
        _DECODE_ARGS[key] = args
    return args


#: the kernels load 16-byte vectors: each tensor they read so must start
#: on a 16-byte boundary (a fresh tensor does; a view at an odd offset may
#: not), checked on the OR of its address with the others'
_UNALIGNED = "the kernel's tensors must be 16-byte aligned"


def _check_tensors(q, kv: dict, ints: dict, tensors) -> None:
    """q float32 or bfloat16, the ``kv`` tensors in q's dtype, the ``ints``
    int32, and every tensor on one device and contiguous.  Plain loops:
    the serve steps are host-bound, and this runs on every launch."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in kv.values():
        if t.dtype != q.dtype:
            raise TypeError(f"{'/'.join(kv)} must have q's dtype {q.dtype}, "
                            f"got {[str(t.dtype) for t in kv.values()]}")
    for t in ints.values():
        if t.dtype != torch.int32:
            raise TypeError(f"{'/'.join(ints)} must be int32")
    tensors = [t for t in tensors if t is not None]
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError("all inputs must lie on one device, got "
                             f"{[str(t.device) for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def _check_pools(q, k_pool, v_pool, k_scale, v_scale, KV, D) -> bool:
    """Pools (n_blocks, bs, KV, D) of one shape whose dtype pairs with q's
    (:data:`POOL_PAIRS`), and scales (n_blocks, bs) float32 passed together
    exactly when the pools are int8.  Returns whether they are."""
    if k_pool.dim() != 4 or k_pool.shape[2:] != (KV, D):
        raise ValueError(f"k_pool must be (n_blocks, bs, {KV}, {D}), got "
                         f"{tuple(k_pool.shape)}")
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} {v_pool.dtype} != "
                         f"k_pool {tuple(k_pool.shape)} {k_pool.dtype}")
    if (q.dtype, k_pool.dtype) not in POOL_PAIRS:
        raise TypeError(f"pools of {k_pool.dtype} under a {q.dtype} q are "
                        f"not served; pairs: {POOL_PAIRS}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scale is not None):
        raise ValueError("int8 pools need k_scale/v_scale, and only int8 "
                         "pools take them")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != tuple(k_pool.shape[:2]):
                raise ValueError(f"{name} must be {tuple(k_pool.shape[:2])}"
                                 f", got {tuple(t.shape)}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
    return quantized


def _check_common(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                  per_slot, KV, D, tensors) -> bool:
    B = q.shape[0]
    quantized = _check_pools(q, k_pool, v_pool, k_scale, v_scale, KV, D)
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be ({B}, nb), got "
                         f"{tuple(block_tables.shape)}")
    for name, t in per_slot.items():
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")
    _check_tensors(q, {}, {"block_tables": block_tables, **per_slot},
                   tensors)
    return quantized


def _check(q, k_pool, v_pool, block_tables, valid_len, k_scale,
           v_scale) -> bool:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, D), got {tuple(q.shape)}")
    _, KV, _, D = q.shape
    return _check_common(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                         {"valid_len": valid_len}, KV, D,
                         (q, k_pool, v_pool, k_scale, v_scale, block_tables,
                          valid_len))


def _check_new(q, k_new, v_new, k_amax, v_amax, quantized: bool, KV: int,
               sharded: bool) -> None:
    """The fused commit's rows: ``k_new``/``v_new`` (B, KV, D) in q's
    dtype, contiguous on q's device, both or neither, with KV the heads the
    call attends; ``k_amax``/``v_amax`` (B,) float32 with them, for int8
    pools only, and needed for int8 pools under ``head_shard``, whose call
    sees only its heads of a row."""
    if k_new is None and v_new is None:
        if k_amax is not None or v_amax is not None:
            raise ValueError("k_amax/v_amax come with k_new/v_new")
        return
    if k_new is None or v_new is None:
        raise ValueError("k_new and v_new must be passed together")
    B, _, _, D = q.shape
    shape = (B, KV, D)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must have q's dtype {q.dtype}, got "
                            f"{t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if k_amax is not None or v_amax is not None:
        _check_amax(k_amax, v_amax, quantized, (B,), q)
    if quantized and sharded and k_amax is None:
        raise ValueError("int8 pools under head_shard need k_amax/v_amax: "
                         "the call sees only its heads of a row")


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       valid_len: torch.Tensor, k_scale=None,
                       v_scale=None, *, head_shard=None, k_new=None,
                       v_new=None, k_amax=None,
                       v_amax=None) -> torch.Tensor:
    """One-token GQA attention over a paged KV cache.

    q (B, KV, G, D); k/v_pool (n_blocks, bs, KV, D) in q's dtype, bf16
    under an f32 q, or int8 with ``k_scale``/``v_scale`` (n_blocks, bs)
    float32, one scale a pool row, dequantized in fp32 as ``code *
    scale``; block_tables (B, nb) int32; valid_len (B,) int32, every entry
    >= 1 and every table entry a block of the pool (not checked: both live
    on the device).  Rows at or past ``valid_len`` and their scales are
    never read.  Returns (B, KV, G, D) in q's dtype.

    ``head_shard=(i, n)`` runs only shard ``i``'s contiguous 1/n of the KV
    heads and returns (B, KV/n, G, D): q's slice is copied (it is small),
    the pools are read in place at their full row stride.  It raises as
    the reference does, for an index outside ``[0, n)`` and for KV not
    divisible by ``n``.

    ``k_new``/``v_new`` (B, KV', D) in q's dtype, the new K and V row of
    each slot over the heads this call attends (KV' = KV, or KV/n under
    ``head_shard``), are first committed in place at position
    ``valid_len[b] - 1`` through the table, as :func:`commit_paged` with
    ``q_start = valid_len - 1`` and ``q_len`` of ones does: converted to
    the pools' dtype, or for int8 pools quantized with a fresh scale from
    the row's amax over all heads, ``k_amax``/``v_amax`` (B,) float32 when
    given (needed under ``head_shard``); then every slot attends, its new
    row included.  On the card this is one launch of the decode kernel,
    whose split that holds the row writes it before reading it;
    ``flash_decode_paged.commit_launches`` counts those launches.
    """
    heads = ref.head_slice(head_shard, q.shape[1] if q.dim() == 4 else 0)
    quantized = _check(q, k_pool, v_pool, block_tables, valid_len, k_scale,
                       v_scale)
    _check_new(q, k_new, v_new, k_amax, v_amax, quantized,
               heads.stop - heads.start, head_shard is not None)
    if q.device.type == "cpu":
        if k_new is not None:
            ref.commit_paged_ref(
                k_new[:, None], v_new[:, None], k_pool[:, :, heads],
                v_pool[:, :, heads], block_tables, valid_len - 1,
                torch.ones_like(valid_len), k_scale, v_scale,
                k_amax=None if k_amax is None else k_amax[:, None],
                v_amax=None if v_amax is None else v_amax[:, None])
        return ref.flash_decode_paged_ref(
            q[:, heads], k_pool[:, :, heads], v_pool[:, :, heads],
            block_tables, valid_len, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, pool_kv, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    _check_head_dim(D)
    kp, vp = k_pool.data_ptr(), v_pool.data_ptr()
    if (kp | vp) % 16:
        raise ValueError(_UNALIGNED)
    if head_shard is not None:
        q = q[:, heads].contiguous()
    KV = q.shape[1]
    out = torch.empty_like(q)
    dev = q.device
    stream = build.stream_of(q)
    split, partial, counters = _decode_args(
        dev, (dev.index, stream, nb * bs, bs, B, KV, G, D))
    err = _launcher("flash_decode_paged", "flash_decode_paged_launch")(
        q.data_ptr(), kp, vp, _ptr(k_scale), _ptr(v_scale),
        block_tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        partial, counters, _ptr(k_new), _ptr(v_new), _ptr(k_amax),
        _ptr(v_amax), B, KV, G, D, bs, nb, pool_kv, heads.start, split,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], dev.index or 0,
        stream,
    )
    build.raise_on("flash_decode_paged", err)
    flash_decode_paged.launches += 1
    if k_new is not None:
        flash_decode_paged.commit_launches += 1
    return out


flash_decode_paged.launches = 0
flash_decode_paged.commit_launches = 0


def flash_decode_paged_sharded(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               valid_len: torch.Tensor, *, mesh,
                               axis: str = "model", k_scale=None,
                               v_scale=None, gather: bool = False,
                               k_new=None, v_new=None, k_amax=None,
                               v_amax=None) -> torch.Tensor:
    """Tensor-parallel paged decode: the reference's ``shard_map`` of the
    decode over a mesh's ``axis``, as one call on each rank.

    Every rank of the axis passes its local q heads (B, KV/n, G, D) and
    its local pools (n_blocks, bs, KV/n, D), the head-sharded layout of
    :func:`repro_torch.distributed.sharding.paged_cache_spec`; the block
    tables, lengths and int8 scales (n_blocks, bs) are whole on every
    rank.  Each rank launches the decode kernel on its own heads and gets
    its head slice (B, KV/n, G, D) of the output, the reference's
    ``out_specs``; no collective is needed, since softmax normalizes
    within a head.  ``gather=True`` all-gathers the slices over ``axis``
    into the whole (B, KV, G, D).  ``k_new``/``v_new`` (B, KV/n, D), the
    rank's heads of each slot's new row, and for int8 pools each row's
    amax over all heads ``k_amax``/``v_amax`` (B,), are committed first,
    as :func:`flash_decode_paged` takes them.  ``launches`` counts the
    calls that launched the kernel.  The global KV is the local KV times
    the axis size, so it always divides; a q whose local heads are not the
    pools' (pools left whole because KV does not divide) raises in the
    decode's shape check.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    out = flash_decode_paged(q, k_pool, v_pool, block_tables, valid_len,
                             k_scale, v_scale, k_new=k_new, v_new=v_new,
                             k_amax=k_amax, v_amax=v_amax)
    if q.device.type == "cuda":
        flash_decode_paged_sharded.launches += 1
    return mesh.gather(out, axis, dim=1) if gather else out


flash_decode_paged_sharded.launches = 0


def _check_dense(q, k, v, valid_len, block_s) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, D), got {tuple(q.shape)}")
    B, KV, _, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (KV, D):
        raise ValueError(f"k must be ({B}, S, {KV}, {D}), got "
                         f"{tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must be ({B},), got "
                         f"{tuple(valid_len.shape)}")
    S = k.shape[1]
    bs = min(block_s, S)
    if bs <= 0 or S % bs:
        raise ValueError(f"S {S} not divisible by block_s {bs}")
    _check_tensors(q, {"k": k, "v": v}, {"valid_len": valid_len},
                   (q, k, v, valid_len))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid_len: torch.Tensor, *, block_s: int = 512,
                 split_rows: int = DECODE_SPLIT) -> torch.Tensor:
    """One-token GQA attention over a contiguous KV cache.

    q (B, KV, G, D); k/v (B, S, KV, D) in q's dtype; valid_len (B,) int32:
    rows at or past ``valid_len[b]`` are never read, and a slot with
    ``valid_len`` 0 gives zeros.  ``block_s`` is the TPU kernel's tile,
    checked as the reference checks it (``S % min(block_s, S) == 0``); the
    CUDA kernel reads K and V in place, in splits of ``split_rows`` rows
    (:func:`decode_plan`, which checks it on the card: its launch
    arguments are cached).  Returns (B, KV, G, D) in q's dtype.
    """
    _check_dense(q, k, v, valid_len, block_s)
    if q.device.type == "cpu":
        check_split(split_rows)
        return ref.decode_plain(q, k, v, valid_len)
    build.require_cuda("flash_decode_paged", (q, k, v, valid_len))
    B, KV, G, D = q.shape
    S = k.shape[1]
    _check_head_dim(D)
    out = torch.empty_like(q)
    if out.numel() == 0:
        check_split(split_rows)
        return out
    kp, vp = k.data_ptr(), v.data_ptr()
    if (kp | vp) % 16:
        raise ValueError(_UNALIGNED)
    dev = q.device
    stream = build.stream_of(q)
    split, partial, counters = _decode_args(
        dev, (dev.index, stream, S, DECODE_TILE, B, KV, G, D, split_rows))
    err = _launcher("flash_decode_paged", "flash_decode_launch")(
        q.data_ptr(), kp, vp, valid_len.data_ptr(), out.data_ptr(), partial,
        counters, B, KV, G, D, S, split, _DTYPE_CODE[q.dtype],
        dev.index or 0, stream)
    build.raise_on("flash_decode_paged", err)
    flash_decode.launches += 1
    flash_decode.variant_launches[split_rows] = \
        flash_decode.variant_launches.get(split_rows, 0) + 1
    return out


flash_decode.launches = 0
flash_decode.variant_launches = {}


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid_len: torch.Tensor, *, block_s: int = 512,
                       split_rows: int = DECODE_SPLIT) -> torch.Tensor:
    _check_dense(q, k, v, valid_len, block_s)
    check_split(split_rows)
    return ref.decode_plain(q, k, v, valid_len)


class PrefillPlan(NamedTuple):
    """How the prefill attention tiles a chunk: blocks of ``rows`` chunk
    rows (``rows * G`` query vectors) walking key tiles of ``key_tile``
    rows, on the ``route`` ("mma": tensor cores, bf16 q over bf16 pools;
    "simt": fp32 on the CUDA cores) with ``smem`` bytes of dynamic shared
    memory."""

    rows: int
    key_tile: int
    route: str
    smem: int


def check_prefill_tiles(q_tile: int, key_tile: int, q_dtype: torch.dtype,
                        pool_dtype: torch.dtype) -> None:
    """Raise unless the attention is compiled for (``q_tile``,
    ``key_tile``) at this (q, pool) pair: :data:`PREFILL_TILES`, the
    default for every pair and the others for :data:`VARIANT_PAIRS`."""
    tiles = (q_tile, key_tile)
    if tiles not in PREFILL_TILES:
        raise ValueError(f"the prefill attention has no launch variant "
                         f"(q_tile, key_tile) = {tiles}; it has "
                         f"{PREFILL_TILES}")
    if tiles != PREFILL_TILES[0] and (q_dtype, pool_dtype) not in \
            VARIANT_PAIRS:
        raise ValueError(f"the prefill variant {tiles} is compiled for "
                         f"{VARIANT_PAIRS} only, not a {q_dtype} q over "
                         f"{pool_dtype} pools")


@functools.lru_cache(maxsize=256)
def prefill_plan(C: int, G: int, D: int, bs: int, nb: int,
                 q_dtype: torch.dtype, pool_dtype: torch.dtype,
                 q_tile: int = PREFILL_VECTORS,
                 key_tile: int = PREFILL_KEYS) -> PrefillPlan:
    """The prefill attention's tiles and shared memory for these shapes,
    as ``prefill_attend_mma`` and ``prefill_attend_simt`` lay them out;
    the launch is given this size, and nothing else computes it.

    A block takes ``min(C, PREFILL_VECTORS // G)`` chunk rows.  A key tile
    is whole pool blocks, ``bs * (PREFILL_KEYS // bs)`` rows, or for
    blocks above :data:`PREFILL_KEYS` rows :data:`PREFILL_KEYS` rows of
    one block.  Tiles are staged in two stages of rows padded by 16 bytes:
    q, then K and V twice, in bf16 on the mma route; on the simt route q
    and p in fp32, the raw stages in the pools' dtype, fp32 copies of the
    K and V tiles for bf16 and int8 pools, and the stages' scales for
    int8.  The table row (``nb`` ints) comes last.  ``q_tile`` and
    ``key_tile`` name a launch variant (:func:`check_prefill_tiles`) and
    take the places of :data:`PREFILL_VECTORS` and :data:`PREFILL_KEYS`.
    Raises when G exceeds ``q_tile`` or the block needs more than
    :data:`SMEM_LIMIT` bytes.
    """
    check_prefill_tiles(q_tile, key_tile, q_dtype, pool_dtype)
    if G > q_tile:
        raise ValueError(f"G={G} query heads a KV head exceed the "
                         f"{q_tile} query vectors of a block")
    rows = max(1, min(C, q_tile // G))
    kt = bs * (key_tile // bs) if bs <= key_tile else key_tile
    item = pool_dtype.itemsize
    nv, nk = q_tile, key_tile
    if (q_dtype, pool_dtype) == (torch.bfloat16, torch.bfloat16):
        route = "mma"
        smem = (nv + 4 * nk) * (2 * D + 16)
    else:
        route = "simt"
        widened = 2 * nk * (D + 4) * 4 if pool_dtype != torch.float32 else 0
        scales = 4 * nk * 4 if pool_dtype == torch.int8 else 0
        smem = (nv * (D + 4) * 4 + nv * (nk + 4) * 4 + widened
                + 4 * nk * (D * item + 16) + scales)
    smem += 4 * nb
    if smem > SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D}, bs={bs}, nb={nb} need {smem} bytes "
                         f"of shared memory, over {SMEM_LIMIT}")
    return PrefillPlan(rows, kt, route, smem)


def _check_chunk(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                 block_tables, q_start, q_len, B, C, KV, D) -> bool:
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, C, KV, D):
            raise ValueError(f"{name} must be ({B}, {C}, {KV}, {D}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must have q's dtype {q.dtype}, got "
                            f"{t.dtype}")
    return _check_common(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                         {"q_start": q_start, "q_len": q_len}, KV, D,
                         (q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                          block_tables, q_start, q_len))


def _check_prefill(q, k_new, v_new, k_pool, v_pool, block_tables, q_start,
                   q_len, k_scale=None, v_scale=None) -> bool:
    if q.dim() != 5:
        raise ValueError(f"q must be (B, C, KV, G, D), got {tuple(q.shape)}")
    B, C, KV, _, D = q.shape
    return _check_chunk(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                        block_tables, q_start, q_len, B, C, KV, D)


def _check_amax(k_amax, v_amax, quantized: bool, shape: tuple, like):
    """Each row's given amax, ``shape`` float32 on ``like``'s device and
    contiguous, both or neither, and only for int8 pools."""
    if (k_amax is None) != (v_amax is None):
        raise ValueError("k_amax and v_amax must be passed together")
    if k_amax is None:
        return
    if not quantized:
        raise ValueError("k_amax/v_amax are given only with int8 pools")
    for name, t in (("k_amax", k_amax), ("v_amax", v_amax)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != like.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {like.device}")


def commit_paged(k_new: torch.Tensor, v_new: torch.Tensor,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor, q_start: torch.Tensor,
                 q_len: torch.Tensor, k_scale=None, v_scale=None, *,
                 k_amax=None, v_amax=None) -> None:
    """Commit a chunk's K/V rows into the paged pools in place, alone: the
    first pass of :func:`flash_prefill_paged`, which a mesh rank runs for
    the other data ranks' rows (a decode step's own rows are committed by
    :func:`flash_decode_paged` given ``k_new``/``v_new``).

    k/v_new (B, C, KV, D) float32 or bfloat16; pools and scales as
    :func:`flash_prefill_paged` takes them.  Rows ``c < q_len[b]`` land at
    position ``q_start[b] + c`` through the block table, converted to the
    pools' dtype or, for int8 pools, quantized with a fresh scale a row
    (:func:`ref.quantize_rows`'s formula, from ``k_amax``/``v_amax`` (B, C)
    float32 when they are given); every other row keeps its bytes and its
    scale.
    """
    if k_new.dim() != 4:
        raise ValueError(f"k_new must be (B, C, KV, D), got "
                         f"{tuple(k_new.shape)}")
    B, C, KV, D = k_new.shape
    quantized = _check_chunk(k_new, k_new, v_new, k_pool, v_pool, k_scale,
                             v_scale, block_tables, q_start, q_len, B, C,
                             KV, D)
    _check_amax(k_amax, v_amax, quantized, (B, C), k_new)
    if k_new.device.type == "cpu":
        ref.commit_paged_ref(k_new, v_new, k_pool, v_pool, block_tables,
                             q_start, q_len, k_scale, v_scale,
                             k_amax=k_amax, v_amax=v_amax)
        return
    build.require_cuda("flash_prefill_paged", (k_new,))
    if k_new.numel() == 0:
        return
    err = _launcher("flash_prefill_paged", "flash_commit_paged_launch")(
        k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), _ptr(k_amax),
        _ptr(v_amax), block_tables.data_ptr(), q_start.data_ptr(),
        q_len.data_ptr(), B, C,
        KV, D, k_pool.shape[1], block_tables.shape[1],
        _DTYPE_CODE[k_new.dtype], _DTYPE_CODE[k_pool.dtype],
        k_new.device.index or 0, build.stream_of(k_new))
    build.raise_on("flash_prefill_paged", err)
    commit_paged.launches += 1


commit_paged.launches = 0


def flash_prefill_paged(q: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        q_start: torch.Tensor, q_len: torch.Tensor,
                        k_scale=None, v_scale=None, *, k_amax=None,
                        v_amax=None, q_tile: int = PREFILL_VECTORS,
                        key_tile: int = PREFILL_KEYS) -> torch.Tensor:
    """Chunked prefill over a paged KV cache: commit, then causal
    attention.

    q (B, C, KV, G, D); k/v_new (B, C, KV, D) in q's dtype; k/v_pool
    (n_blocks, bs, KV, D) in q's dtype, bf16 under an f32 q, or int8 with
    ``k_scale``/``v_scale`` (n_blocks, bs) float32; block_tables (B, nb),
    q_start and q_len (B,) int32.  Rows ``c < q_len[b]`` are written into
    the pools in place at position ``q_start[b] + c`` through the block
    table, which must map every such position (not checked: the values
    live on the device): converted to the pools' dtype, or quantized with
    a fresh scale a row for int8 pools.  Each such row then attends to its
    slot's keys up to its own position, dequantized in fp32.  Rows at or
    past ``q_len[b]`` commit nothing and come out as zeros; every other
    pool row keeps its bytes and its scale.  ``k_amax``/``v_amax`` go to
    the commit, as :func:`commit_paged` takes them.  Returns (B, C, KV, G,
    D) in q's dtype.  On the card: the commit kernel, then the attention
    kernel (the launch variant ``q_tile`` x ``key_tile``), on the current
    stream.
    """
    quantized = _check_prefill(q, k_new, v_new, k_pool, v_pool,
                               block_tables, q_start, q_len, k_scale,
                               v_scale)
    _check_amax(k_amax, v_amax, quantized, tuple(q.shape[:2]), q)
    if q.device.type == "cpu":
        # on the card the cached prefill_plan checks the tiles
        check_prefill_tiles(q_tile, key_tile, q.dtype, k_pool.dtype)
        return ref.flash_prefill_paged_ref(q, k_new, v_new, k_pool, v_pool,
                                           block_tables, q_start, q_len,
                                           k_scale, v_scale, k_amax=k_amax,
                                           v_amax=v_amax)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, C, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    _check_head_dim(D)
    plan = prefill_plan(C, G, D, bs, nb, q.dtype, k_pool.dtype, q_tile,
                        key_tile)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    qp, kp, vp = q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError(_UNALIGNED)
    args = [qp, k_new.data_ptr(), v_new.data_ptr(), kp, vp, _ptr(k_scale),
            _ptr(v_scale), _ptr(k_amax), _ptr(v_amax), block_tables.data_ptr(),
            q_start.data_ptr(), q_len.data_ptr(), out.data_ptr(), B, C, KV, G,
            D, bs, nb, plan.rows,
            plan.key_tile, plan.smem, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pool.dtype]]
    tiles = (q_tile, key_tile)
    if tiles == PREFILL_TILES[0]:
        library, symbol = "flash_prefill_paged", "flash_prefill_paged_launch"
    else:
        library = "flash_prefill_variants"
        symbol = "flash_prefill_variant_launch"
        args += tiles
    err = _launcher(library, symbol)(*args, q.device.index or 0,
                                     build.stream_of(q))
    build.raise_on(library, err)
    flash_prefill_paged.launches += 1
    by_width = flash_prefill_paged.launches_by_width
    by_width[C] = by_width.get(C, 0) + 1
    by_tiles = flash_prefill_paged.variant_launches
    by_tiles[tiles] = by_tiles.get(tiles, 0) + 1
    return out


flash_prefill_paged.launches = 0
#: (q_tile, key_tile) -> launches of that variant
flash_prefill_paged.variant_launches = {}
#: chunk width C -> launches at that width (speculative decoding runs the
#: draft's rounds at width 1 and verification at ``spec_k + 1``)
flash_prefill_paged.launches_by_width = {}


def _prefill_op(fn, q, k_new, v_new, k_pool, v_pool, block_tables, q_start,
                q_len, k_scale, v_scale, block_c, block_s, tiles):
    if q.dim() != 5:
        raise ValueError(f"q must be (B, C, KV, G, D), got {tuple(q.shape)}")
    B, C = q.shape[:2]
    bc = min(block_c, C)
    if bc <= 0 or C % bc:
        raise ValueError(f"C {C} not divisible by block_c {bc}")
    bs = k_pool.shape[1] if k_pool.dim() == 4 else 0
    bks = min(block_s, bs) if block_s else bs
    if bks <= 0 or bs % bks:
        raise ValueError(f"block size {bs} not divisible by block_s {bks}")
    if q_len is None:
        q_len = torch.full((B,), C, dtype=torch.int32, device=q.device)
    out = fn(q, k_new, v_new, k_pool, v_pool, block_tables, q_start, q_len,
             k_scale, v_scale, **tiles)
    scales = () if k_scale is None else (k_scale, v_scale)
    return (out, k_pool, v_pool, *scales)


def flash_prefill(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_tables: torch.Tensor, q_start: torch.Tensor,
                  q_len=None, *, k_scale=None, v_scale=None,
                  block_c: int = 8, block_s: int = 0,
                  q_tile: int = PREFILL_VECTORS,
                  key_tile: int = PREFILL_KEYS):
    """Chunked prefill with the reference's argument list: returns (out,
    k_pool, v_pool), and ``k_scale, v_scale`` after them with int8 pools,
    committed in place by :func:`flash_prefill_paged` (the reference
    returns new arrays).  ``q_len`` defaults to the chunk width C.
    ``block_c`` and ``block_s`` are the TPU kernel's tiles, checked as the
    reference checks them (C divisible by ``min(block_c, C)``, the block
    size by ``block_s`` when it is not 0); ``q_tile`` and ``key_tile`` the
    CUDA launch variant, as :func:`flash_prefill_paged` takes them.
    """
    return _prefill_op(flash_prefill_paged, q, k_new, v_new, k_pool, v_pool,
                       block_tables, q_start, q_len, k_scale, v_scale,
                       block_c, block_s,
                       dict(q_tile=q_tile, key_tile=key_tile))


def flash_prefill_plain(q, k_new, v_new, k_pool, v_pool, block_tables,
                        q_start, q_len=None, *, k_scale=None, v_scale=None,
                        block_c: int = 8, block_s: int = 0,
                        q_tile: int = PREFILL_VECTORS,
                        key_tile: int = PREFILL_KEYS):
    """:func:`flash_prefill` with the plain version on any device."""
    def plain(*args, q_tile, key_tile):
        _check_prefill(*args)
        check_prefill_tiles(q_tile, key_tile, args[0].dtype, args[3].dtype)
        return ref.flash_prefill_paged_ref(*args)

    return _prefill_op(plain, q, k_new, v_new, k_pool, v_pool, block_tables,
                       q_start, q_len, k_scale, v_scale, block_c, block_s,
                       dict(q_tile=q_tile, key_tile=key_tile))
