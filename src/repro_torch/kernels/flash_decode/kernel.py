"""Flash-decode (paged and contiguous) and chunked prefill: the wrappers of
the CUDA kernels in ``csrc/``.

Both CUDA sources are built and loaded at first use by
:mod:`repro_torch.kernels.build`, into ``build/`` beside ``csrc/``.

:func:`flash_decode_paged`, :func:`flash_decode` and
:func:`flash_prefill_paged` take CPU tensors to their plain versions in
``ref.py`` and launch their kernels for CUDA tensors; there is no fallback
from one to the other.  Each wrapper's ``launches`` attribute counts the
calls that launched its kernels.  :func:`flash_decode` and
:func:`flash_prefill` take the reference's argument lists and check its
tile arguments (``block_s``, ``block_c``) as it does; the CUDA kernels'
tiles are their own.  ``*_plain`` are the same functions, with the same
checks, in plain PyTorch on any device.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: dynamic shared memory a block may use without an opt-in attribute
_SMEM_LIMIT = 48 * 1024
#: chunk rows per thread block of the prefill attention, at most
PREFILL_ROWS = 16
#: cache rows per tile of the contiguous decode kernel
DECODE_TILE = 64

#: (library, C function) -> argument types
_ARGTYPES: Dict[tuple, list] = {
    ("flash_decode_paged", "flash_decode_paged_launch"):
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ("flash_decode_paged", "flash_decode_launch"):
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ("flash_prefill_paged", "flash_prefill_paged_launch"):
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
}


def _launcher(library: str, symbol: str):
    return build.function(library, symbol, _ARGTYPES[library, symbol])


def _check_head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")


def _decode_smem_bytes(G: int, D: int, rows: int, table: int) -> int:
    """Dynamic shared memory of one decode block: q and acc (G*D each),
    the scores of a tile (G*rows) and m, l, corr (G each) in fp32, and
    ``table`` block-table entries, as ``flash_decode_kernel`` lays them
    out; raises above the limit without an opt-in."""
    smem = 4 * (2 * G * D + G * rows + 3 * G) + 4 * table
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D}, tile rows={rows}, table={table} "
                         f"need {smem} bytes of shared memory, over "
                         f"{_SMEM_LIMIT}")
    return smem


def _check_tensors(q, kv: dict, ints: dict, tensors) -> None:
    """q float32 or bfloat16, the ``kv`` tensors in q's dtype, the ``ints``
    int32, and every tensor on one device and contiguous."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in kv.values()):
        raise TypeError(f"{'/'.join(kv)} must have q's dtype {q.dtype}, got "
                        f"{[str(t.dtype) for t in kv.values()]}")
    if any(t.dtype != torch.int32 for t in ints.values()):
        raise TypeError(f"{'/'.join(ints)} must be int32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must lie on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def _check_common(q, k_pool, v_pool, block_tables, per_slot, KV, D,
                  tensors) -> None:
    B = q.shape[0]
    if k_pool.dim() != 4 or k_pool.shape[2:] != (KV, D):
        raise ValueError(f"k_pool must be (n_blocks, bs, {KV}, {D}), got "
                         f"{tuple(k_pool.shape)}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be ({B}, nb), got "
                         f"{tuple(block_tables.shape)}")
    for name, t in per_slot.items():
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")
    _check_tensors(q, {"k_pool": k_pool, "v_pool": v_pool},
                   {"block_tables": block_tables, **per_slot}, tensors)


def _check(q, k_pool, v_pool, block_tables, valid_len) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, D), got {tuple(q.shape)}")
    _, KV, _, D = q.shape
    _check_common(q, k_pool, v_pool, block_tables, {"valid_len": valid_len},
                  KV, D, (q, k_pool, v_pool, block_tables, valid_len))


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       valid_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over a paged KV cache.

    q (B, KV, G, D); k/v_pool (n_blocks, bs, KV, D) in q's dtype;
    block_tables (B, nb) int32; valid_len (B,) int32, every entry >= 1 and
    every table entry a block of the pool (not checked: both live on the
    device).  Returns (B, KV, G, D) in q's dtype.
    """
    _check(q, k_pool, v_pool, block_tables, valid_len)
    if q.device.type == "cpu":
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, block_tables,
                                          valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    _check_head_dim(D)
    _decode_smem_bytes(G, D, bs, nb)
    out = torch.empty_like(q)
    err = _launcher("flash_decode_paged", "flash_decode_paged_launch")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        B, KV, G, D, bs, nb, _DTYPE_CODE[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on("flash_decode_paged", err)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


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
                 valid_len: torch.Tensor, *,
                 block_s: int = 512) -> torch.Tensor:
    """One-token GQA attention over a contiguous KV cache.

    q (B, KV, G, D); k/v (B, S, KV, D) in q's dtype; valid_len (B,) int32:
    rows at or past ``valid_len[b]`` are never read, and a slot with
    ``valid_len`` 0 gives zeros.  ``block_s`` is the TPU kernel's tile,
    checked as the reference checks it (``S % min(block_s, S) == 0``); the
    CUDA kernel reads K and V in place in tiles of :data:`DECODE_TILE`
    rows.  Returns (B, KV, G, D) in q's dtype.
    """
    _check_dense(q, k, v, valid_len, block_s)
    if q.device.type == "cpu":
        return ref.decode_plain(q, k, v, valid_len)
    build.require_cuda("flash_decode_paged", (q, k, v, valid_len))
    B, KV, G, D = q.shape
    S = k.shape[1]
    _check_head_dim(D)
    _decode_smem_bytes(G, D, DECODE_TILE, 0)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _launcher("flash_decode_paged", "flash_decode_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
        out.data_ptr(), B, KV, G, D, S, DECODE_TILE, _DTYPE_CODE[q.dtype],
        q.device.index or 0, build.stream_of(q))
    build.raise_on("flash_decode_paged", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid_len: torch.Tensor, *,
                       block_s: int = 512) -> torch.Tensor:
    _check_dense(q, k, v, valid_len, block_s)
    return ref.decode_plain(q, k, v, valid_len)


def prefill_smem_bytes(bc: int, G: int, D: int, bs: int, nb: int) -> int:
    """Dynamic shared memory of one prefill attention block of ``bc``
    chunk rows: q and acc (bc*G*D each), the V tile (bs*D), the scores
    (bc*G*bs) and m, l, corr (bc*G each) in fp32, and the table row, as
    ``prefill_attend_kernel`` lays them out.  The launch is given this
    size; nothing else computes it."""
    r = bc * G
    return 4 * (2 * r * D + bs * D + r * bs + 3 * r) + 4 * nb


def prefill_rows_per_block(C: int, G: int, D: int, bs: int, nb: int) -> int:
    """Chunk rows per attention block: at most :data:`PREFILL_ROWS` and
    ``C``, halved until the block's shared memory fits without an opt-in;
    raises when one row does not fit."""
    bc = min(PREFILL_ROWS, C)
    while bc > 1 and prefill_smem_bytes(bc, G, D, bs, nb) > _SMEM_LIMIT:
        bc //= 2
    smem = prefill_smem_bytes(bc, G, D, bs, nb)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D}, bs={bs}, nb={nb} need {smem} bytes "
                         f"of shared memory for one chunk row, over "
                         f"{_SMEM_LIMIT}")
    return bc


def _check_prefill(q, k_new, v_new, k_pool, v_pool, block_tables, q_start,
                   q_len) -> None:
    if q.dim() != 5:
        raise ValueError(f"q must be (B, C, KV, G, D), got {tuple(q.shape)}")
    B, C, KV, _, D = q.shape
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, C, KV, D):
            raise ValueError(f"{name} must be ({B}, {C}, {KV}, {D}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must have q's dtype {q.dtype}, got "
                            f"{t.dtype}")
    _check_common(q, k_pool, v_pool, block_tables,
                  {"q_start": q_start, "q_len": q_len}, KV, D,
                  (q, k_new, v_new, k_pool, v_pool, block_tables, q_start,
                   q_len))


def flash_prefill_paged(q: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        q_start: torch.Tensor,
                        q_len: torch.Tensor) -> torch.Tensor:
    """Chunked prefill over a paged KV cache: commit, then causal
    attention.

    q (B, C, KV, G, D); k/v_new (B, C, KV, D) and k/v_pool (n_blocks, bs,
    KV, D) in q's dtype; block_tables (B, nb), q_start and q_len (B,)
    int32.  Rows ``c < q_len[b]`` are written into the pools in place at
    position ``q_start[b] + c`` through the block table, which must map
    every such position (not checked: the values live on the device); each
    such row then attends to its slot's keys up to its own position.  Rows
    at or past ``q_len[b]`` commit nothing and come out as zeros.  Returns
    (B, C, KV, G, D) in q's dtype.  On the card: the commit kernel, then
    the attention kernel, on the current stream.
    """
    _check_prefill(q, k_new, v_new, k_pool, v_pool, block_tables, q_start,
                   q_len)
    if q.device.type == "cpu":
        return ref.flash_prefill_paged_ref(q, k_new, v_new, k_pool, v_pool,
                                           block_tables, q_start, q_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, C, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    _check_head_dim(D)
    bc = prefill_rows_per_block(C, G, D, bs, nb)
    # the commit copies rows as 16-byte words
    if any(t.data_ptr() % 16 for t in (k_new, v_new, k_pool, v_pool)):
        raise ValueError("k/v_new and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = _launcher("flash_prefill_paged", "flash_prefill_paged_launch")(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), q_start.data_ptr(),
        q_len.data_ptr(), out.data_ptr(), B, C, KV, G, D, bs, nb, bc,
        prefill_smem_bytes(bc, G, D, bs, nb), _DTYPE_CODE[q.dtype],
        q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on("flash_prefill_paged", err)
    flash_prefill_paged.launches += 1
    return out


flash_prefill_paged.launches = 0


def _prefill_op(fn, q, k_new, v_new, k_pool, v_pool, block_tables, q_start,
                q_len, k_scale, v_scale, block_c, block_s):
    if k_scale is not None or v_scale is not None:
        raise ValueError("not ported yet: int8 pools with k_scale/v_scale "
                         "are ROADMAP item 1.11")
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
    out = fn(q, k_new, v_new, k_pool, v_pool, block_tables, q_start, q_len)
    return out, k_pool, v_pool


def flash_prefill(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_tables: torch.Tensor, q_start: torch.Tensor,
                  q_len=None, *, k_scale=None, v_scale=None,
                  block_c: int = 8, block_s: int = 0):
    """Chunked prefill with the reference's argument list: returns (out,
    k_pool, v_pool), the pools committed in place by
    :func:`flash_prefill_paged` (the reference returns new pools).
    ``q_len`` defaults to the chunk width C.  ``block_c`` and ``block_s``
    are the TPU kernel's tiles, checked as the reference checks them (C
    divisible by ``min(block_c, C)``, the block size by ``block_s`` when
    it is not 0); int8 pools with scales are not ported (ROADMAP 1.11).
    """
    return _prefill_op(flash_prefill_paged, q, k_new, v_new, k_pool, v_pool,
                       block_tables, q_start, q_len, k_scale, v_scale,
                       block_c, block_s)


def flash_prefill_plain(q, k_new, v_new, k_pool, v_pool, block_tables,
                        q_start, q_len=None, *, k_scale=None, v_scale=None,
                        block_c: int = 8, block_s: int = 0):
    """:func:`flash_prefill` with the plain version on any device."""
    def plain(*args):
        _check_prefill(*args)
        return ref.flash_prefill_paged_ref(*args)

    return _prefill_op(plain, q, k_new, v_new, k_pool, v_pool, block_tables,
                       q_start, q_len, k_scale, v_scale, block_c, block_s)
