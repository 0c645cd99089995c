"""Paged flash-decode and chunked prefill: the wrappers of the CUDA kernels
in ``csrc/``.

Both CUDA sources are built and loaded at first use by
:mod:`repro_torch.kernels.build`, into ``build/`` beside ``csrc/``.

:func:`flash_decode_paged` and :func:`flash_prefill_paged` take CPU tensors
to their plain versions in ``ref.py`` and launch their kernels for CUDA
tensors; there is no fallback from one to the other.  Each wrapper's
``launches`` attribute counts the calls that launched its kernels.
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
HEAD_DIMS = (64, 128)
#: dynamic shared memory a block may use without an opt-in attribute
_SMEM_LIMIT = 48 * 1024
#: chunk rows per thread block of the prefill attention, at most
PREFILL_ROWS = 16

_ARGTYPES: Dict[str, list] = {
    "flash_decode_paged": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p]),
    "flash_prefill_paged": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                            + [ctypes.c_void_p]),
}


def _launcher(name: str):
    return build.function(name, f"{name}_launch", _ARGTYPES[name])


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
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools must have q's dtype {q.dtype}, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if (block_tables.dtype != torch.int32
            or any(t.dtype != torch.int32 for t in per_slot.values())):
        raise TypeError(f"block_tables and {'/'.join(per_slot)} must be "
                        f"int32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must lie on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


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
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    smem = 4 * (2 * G * D + G * bs + 3 * G) + 4 * nb
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D}, bs={bs}, nb={nb} need {smem} bytes "
                         f"of shared memory, over {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    err = _launcher("flash_decode_paged")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        B, KV, G, D, bs, nb, _DTYPE_CODE[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on("flash_decode_paged", err)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


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
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    bc = prefill_rows_per_block(C, G, D, bs, nb)
    # the commit copies rows as 16-byte words
    if any(t.data_ptr() % 16 for t in (k_new, v_new, k_pool, v_pool)):
        raise ValueError("k/v_new and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = _launcher("flash_prefill_paged")(
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
