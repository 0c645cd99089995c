"""Plain PyTorch versions of the flash-decode and chunked-prefill kernels,
their oracles and their analytic work terms, across from
:mod:`repro.kernels.flash_decode.ref`.

:func:`decode_ref` ports the reference's contiguous-cache oracle, and
:func:`decode_plain` is the kernel's function: the same fp32 masked
softmax, with zeros for a slot whose ``valid_len`` is 0 (the Pallas
kernel's clamped sum; the oracle gives the mean of v there).
:func:`flash_decode_paged_ref` ports ``decode_paged_ref``: gather each
slot's logical view through its block table, then the oracle.
:func:`flash_prefill_paged_ref` ports ``prefill_paged_ref``: commit the
chunk's K/V rows into the pools in place (:func:`commit_paged_ref`), then
causal attention over each slot's gathered view; :func:`prefill_paged_ref`
is the reference's functional form of it.
:func:`decode_split_merge` models the decode kernel's split of a slot's
rows across blocks and its ordered merge, for the tests.
:func:`flash_decode_paged_sharded_ref` is the plain version of the
reference's ``flash_decode_paged_sharded``: the concatenation of
:func:`flash_decode_paged_ref` over the head slices.  Pools are in q's
dtype, bf16 under an f32 q, or int8 with one fp32 scale per pool row
(:func:`quantize_rows`, dequantized in fp32 as ``code * scale`` by
:func:`dequantize_pool`).  The CPU path and the tests use them; on the
card they serve only as the yardsticks the kernels are compared with.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_len: torch.Tensor) -> torch.Tensor:
    """q (B,KV,G,D); k/v (B,S,KV,D); valid_len (B,) -> (B,KV,G,D) in q's
    dtype: fp32 scores, masked past ``valid_len``, fp32 softmax and p @ v.
    """
    D = q.shape[-1]
    S = k.shape[1]
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) / math.sqrt(D)
    mask = (torch.arange(S, device=q.device)[None, :]
            < valid_len.long()[:, None])  # (B, S)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v.float()).to(q.dtype)


def decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid_len: torch.Tensor) -> torch.Tensor:
    """The contiguous decode kernel's function: :func:`decode_ref`, with
    zeros for every slot whose ``valid_len`` is 0 or less."""
    out = decode_ref(q, k, v, valid_len)
    return out.masked_fill((valid_len <= 0)[:, None, None, None], 0.0)


def decode_split_merge(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid_len: torch.Tensor,
                       split_rows: int) -> torch.Tensor:
    """The decode kernel's split-and-merge, in plain torch (for the tests):
    q (B,KV,G,D); k/v (B,S,KV,D); valid_len (B,).  Split z of a slot takes
    its rows ``[z * split_rows, (z + 1) * split_rows)`` below
    ``valid_len``, and keeps its running max m, sum l and accumulator acc
    (fp32); the splits with live rows are then merged in split order,
    each rescaled by ``exp(m_z - max_z m_z)``.  A slot whose ``valid_len``
    is 0 or less gives zeros, as :func:`decode_plain` does.  Returns
    (B,KV,G,D) in q's dtype."""
    B, KV, G, D = q.shape
    S = k.shape[1]
    qf = q.float()
    rows = torch.arange(S, device=q.device)
    live = rows[None, :] < valid_len.long()[:, None]            # (B, S)
    m = l = acc = None
    for z0 in range(0, S, split_rows):
        z1 = min(z0 + split_rows, S)
        s = torch.einsum("bkgd,bskd->bkgs", qf,
                         k[:, z0:z1].float()) / math.sqrt(D)
        s = s.masked_fill(~live[:, None, None, z0:z1], -math.inf)
        mz = s.amax(dim=-1)                                     # (B,KV,G)
        has = live[:, z0:z1].any(dim=1)[:, None, None]          # (B,1,1)
        base = torch.where(has, mz, torch.zeros_like(mz))
        p = torch.exp(s - base[..., None])
        lz = p.sum(dim=-1)
        az = torch.einsum("bkgs,bskd->bkgd", p, v[:, z0:z1].float())
        if m is None:
            m, l, acc = mz, lz, az
            continue
        mn = torch.maximum(m, mz)
        keep = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
        a, c = torch.exp(m - keep), torch.exp(mz - keep)
        m, l, acc = mn, l * a + lz * c, acc * a[..., None] + az * c[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.masked_fill((valid_len <= 0)[:, None, None, None], 0.0)
    return out.to(q.dtype)


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """Each row's amax over its (KV, D) extent, fp32: x (..., KV, D) ->
    (...)."""
    return x.float().abs().amax(dim=(-2, -1))


def quantize_rows(x: torch.Tensor, amax=None):
    """Per-row symmetric int8 of a pool-layout array ``x`` (..., KV, D):
    one fp32 scale per row, amax over the row's (KV, D) extent, as the
    reference's Pallas commit and its serving cell compute it (``s =
    max(amax / 127, 1e-8)``, codes ``clip(round_half_even(x / s), -127,
    127)``), bit for bit.  Compiled by XLA, the division by the constant
    127 becomes a product with its fp32 reciprocal, which the port
    follows; the reference's eager ``quantize_rows`` divides, and its
    scale then differs by one ulp in a few percent of rows.  ``amax``
    (fp32, shaped like ``x`` minus its last two axes), when given, is each
    row's amax over more heads than ``x`` holds: a tensor-parallel rank's
    rows over all ranks' heads.  Returns (int8 codes, fp32 scales shaped
    like ``x`` minus its last two axes)."""
    xf = x.float()
    if amax is None:
        amax = row_amax(x)
    s = torch.clamp(amax * (1.0 / 127.0), min=1e-8)
    codes = torch.clamp(torch.round(xf / s[..., None, None]), -127, 127)
    return codes.to(torch.int8), s


def dequantize_pool(pool: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Widen an int8 pool (n_blocks, bs, KV, D) to fp32 with its per-row
    scales (n_blocks, bs)."""
    return pool.float() * scale[..., None, None]


def _widen(pool: torch.Tensor, scale) -> torch.Tensor:
    return pool.float() if scale is None else dequantize_pool(pool, scale)


def flash_decode_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           valid_len: torch.Tensor, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """q (B,KV,G,D); k/v_pool (n_blocks, bs, KV, D); block_tables (B, nb)
    int32; valid_len (B,) int32 with every slot >= 1 -> (B,KV,G,D) in q's
    dtype.  With int8 pools, ``k_scale``/``v_scale`` (n_blocks, bs) fp32
    dequantize the gathered rows."""
    B, KV, _, D = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    idx = block_tables.long()
    k = _widen(k_pool[idx], None if k_scale is None else k_scale[idx])
    v = _widen(v_pool[idx], None if v_scale is None else v_scale[idx])
    return decode_ref(q, k.reshape(B, nb * bs, KV, D),
                      v.reshape(B, nb * bs, KV, D), valid_len)


def head_slice(head_shard, KV: int) -> slice:
    """The KV heads ``[i * KV / n, (i + 1) * KV / n)`` of ``head_shard =
    (i, n)`` (all of them for None), checked as the reference checks
    it."""
    if head_shard is None:
        return slice(0, KV)
    idx, n = head_shard
    if not 0 <= idx < n:
        raise ValueError(f"head_shard index {idx} outside [0, {n})")
    if KV % n:
        raise ValueError(f"{KV} KV heads not divisible into {n} shards")
    per = KV // n
    return slice(idx * per, (idx + 1) * per)


def flash_decode_paged_sharded_ref(q, k_pool, v_pool, block_tables,
                                   valid_len, n: int, k_scale=None,
                                   v_scale=None) -> torch.Tensor:
    """The head-sharded decode over ``n`` shards, every shard's slice of q
    and the pools through :func:`flash_decode_paged_ref`, concatenated on
    the head axis: equal to the unsharded call, since softmax normalizes
    within a head."""
    KV = q.shape[1]
    parts = []
    for i in range(n):
        h = head_slice((i, n), KV)
        parts.append(flash_decode_paged_ref(q[:, h], k_pool[:, :, h],
                                            v_pool[:, :, h], block_tables,
                                            valid_len, k_scale, v_scale))
    return torch.cat(parts, dim=1)


def _row_bytes(pool: torch.Tensor, quantized: bool) -> int:
    """Bytes of one cached position: its K and V rows over every KV head
    in the pool's dtype, plus their two fp32 scales when the pools are
    int8."""
    KV, D = pool.shape[-2:]
    return 2 * KV * D * pool.element_size() + (8 if quantized else 0)


def _decode_terms(q: torch.Tensor, lens, extra_bytes: int,
                  row_bytes: float) -> dict:
    B, KV, G, D = q.shape
    live = sum(lens)
    item = q.element_size()
    bytes_ = (2 * B * KV * G * D * item        # q in, output out
              + live * row_bytes               # live K and V rows
              + 4 * B + extra_bytes)           # valid_len, tables
    return {"bytes": float(bytes_), "flops": 4.0 * live * KV * G * D}


def work_terms(q: torch.Tensor, k_pool: torch.Tensor,
               block_tables: torch.Tensor, valid_len,
               quantized: bool = False) -> dict:
    """Bytes the paged call must move and flops it must do, for these
    inputs.

    Each input is counted once: q, the live K and V rows (``valid_len``
    rows per slot and KV head, in the pools' dtype), their fp32 scales
    when ``quantized`` (one K and one V scale a live row), the block-table
    entries those rows need, ``valid_len`` itself, and the output.  Flops:
    2 for q.k and 2 for p.v per live row, query head and element.
    """
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    lens = [min(int(v), nb * bs) for v in valid_len]
    tiles = sum(-(-n // bs) for n in lens)
    return _decode_terms(q, lens, 4 * tiles, _row_bytes(k_pool, quantized))


def decode_work_terms(q: torch.Tensor, k: torch.Tensor, valid_len) -> dict:
    """Bytes the contiguous call must move and flops it must do, for these
    inputs: q, the live K and V rows (``valid_len`` rows per slot and KV
    head, clamped to [0, S]), ``valid_len`` and the output, each once."""
    S = k.shape[1]
    return _decode_terms(q, [min(max(int(v), 0), S) for v in valid_len], 0,
                         _row_bytes(k, False))


def chunk_positions(q_start: torch.Tensor, C: int, nb: int, bs: int):
    """Global positions (B, C) of a chunk's rows and the logical block
    (B, C) each falls in, clamped to the table's last entry: padded rows
    past ``q_len`` may run past the table, and are never committed."""
    pos = q_start.long()[:, None] + torch.arange(C, device=q_start.device)
    return pos, torch.clamp(pos // bs, max=nb - 1)


def commit_rows(block_tables: torch.Tensor, q_start: torch.Tensor,
                q_len: torch.Tensor, C: int, bs: int):
    """(src, dst): the chunk rows ``c < q_len[b]`` as indices into the
    (B*C) rows of k/v_new and the (n_blocks*bs) rows of a pool.  Selecting
    them waits for the device to count them."""
    B, nb = block_tables.shape
    pos, j = chunk_positions(q_start, C, nb, bs)
    flat = block_tables.long().gather(1, j) * bs + pos % bs   # (B, C)
    valid = (torch.arange(C, device=q_start.device)[None, :]
             < q_len.long()[:, None])                         # (B, C)
    src = valid.reshape(-1).nonzero().squeeze(1)
    return src, flat.reshape(-1)[src]


def commit_paged_ref(k_new: torch.Tensor, v_new: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     block_tables: torch.Tensor, q_start: torch.Tensor,
                     q_len: torch.Tensor, k_scale=None, v_scale=None, *,
                     k_amax=None, v_amax=None, rows=None) -> None:
    """Write rows ``c < q_len[b]`` of k/v_new (B, C, KV, D) into the pools
    in place at position ``q_start[b] + c`` through the block table:
    converted to the pools' dtype, or, with ``k_scale``/``v_scale``
    (n_blocks, bs) fp32 beside int8 pools, quantized by
    :func:`quantize_rows` with each row's scale written at the same pool
    row; with ``k_amax``/``v_amax`` (B, C) fp32 each row's scale comes from
    the given amax instead of its own (a tensor-parallel rank's rows hold
    only its heads).  Every other row keeps its bytes and its scale.  The
    pools may be a head slice of larger ones (a view, written through).
    ``rows`` is :func:`commit_rows` of these inputs, computed here when not
    given."""
    B, C, KV, D = k_new.shape
    bs = k_pool.shape[1]
    src, dst = rows if rows is not None else commit_rows(
        block_tables, q_start, q_len, C, bs)
    n = k_pool.shape[0] * bs
    for new, pool, scale, amax in ((k_new, k_pool, k_scale, k_amax),
                                   (v_new, v_pool, v_scale, v_amax)):
        x = new.reshape(B * C, KV, D)[src]
        if scale is None:
            _put_rows(pool, dst, x.to(pool.dtype))
        else:
            codes, s = quantize_rows(
                x, None if amax is None else amax.reshape(B * C)[src])
            _put_rows(pool, dst, codes)
            scale.view(n)[dst] = s


def _put_rows(pool: torch.Tensor, dst: torch.Tensor,
              rows: torch.Tensor) -> None:
    """Pool rows ``dst`` (block * bs + row) = ``rows``, in place, also into
    a head slice of the pools (``pool[:, :, heads]``, not contiguous)."""
    if pool.is_contiguous():
        pool.view(-1, *pool.shape[2:])[dst] = rows
    else:
        bs = pool.shape[1]
        pool[dst // bs, dst % bs] = rows


def flash_prefill_paged_ref(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            q_start: torch.Tensor, q_len: torch.Tensor,
                            k_scale=None, v_scale=None, *, k_amax=None,
                            v_amax=None, rows=None) -> torch.Tensor:
    """Chunked prefill over a paged cache: commit, then causal attention.

    q (B,C,KV,G,D); k/v_new (B,C,KV,D) in q's dtype; k/v_pool (n_blocks,
    bs, KV, D) in q's dtype, bf16, or int8 with ``k_scale``/``v_scale``
    (n_blocks, bs) fp32; block_tables (B, nb) int32; q_start, q_len (B,)
    int32.  Rows ``c < q_len[b]`` of slot ``b`` are committed in place
    (:func:`commit_paged_ref`) at position ``q_start[b] + c``; each such
    row then attends to its slot's keys at positions ``<= q_start[b] +
    c``, dequantized in fp32.  Rows at or past ``q_len[b]`` commit nothing
    and come out as zeros.  Returns (B,C,KV,G,D) in q's dtype.  ``rows``
    is :func:`commit_rows` of these inputs, computed here when not given;
    with it given the call never waits for the device.  ``k_amax`` and
    ``v_amax`` go to the commit.
    """
    B, C, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    commit_paged_ref(k_new, v_new, k_pool, v_pool, block_tables, q_start,
                     q_len, k_scale, v_scale, k_amax=k_amax, v_amax=v_amax,
                     rows=rows)
    pos, _ = chunk_positions(q_start, C, nb, bs)
    idx = block_tables.long()
    valid = (torch.arange(C, device=q.device)[None, :]
             < q_len.long()[:, None])                         # (B, C)

    k = _widen(k_pool[idx], None if k_scale is None else k_scale[idx])
    v = _widen(v_pool[idx], None if v_scale is None else v_scale[idx])
    k = k.reshape(B, nb * bs, KV, D)
    v = v.reshape(B, nb * bs, KV, D)
    s = torch.einsum("bckgd,bskd->bckgs", q.float(), k) / math.sqrt(D)
    keys = torch.arange(nb * bs, device=q.device)
    causal = keys[None, None, :] <= pos[:, :, None]           # (B, C, S)
    s = s.masked_fill(~causal[:, :, None, None, :], NEG_INF)
    out = torch.einsum("bckgs,bskd->bckgd", torch.softmax(s, dim=-1), v)
    out = out.masked_fill(~valid[:, :, None, None, None], 0.0)
    return out.to(q.dtype)


def prefill_work_terms(q: torch.Tensor, k_pool: torch.Tensor,
                       block_tables: torch.Tensor, q_start,
                       q_len, quantized: bool = False) -> dict:
    """Bytes the chunked-prefill call must move and flops it must do, for
    these inputs.

    Each byte is counted once: the query rows and K/V chunk rows below
    ``q_len`` (in q's dtype), the same chunk rows written into the pools
    (in the pools' dtype, with their fp32 scales when ``quantized``), the
    K and V rows already in each slot's cache read once (``q_start`` rows,
    likewise; none for a slot with ``q_len`` 0, and the new rows are
    attended from what was read of k/v_new, not read back), the table
    entries those rows need, ``q_start`` and ``q_len``, and the whole
    output.  Flops: 4 per element and query head for every (query row,
    causal key) pair, ``q_start + c + 1`` keys for row ``c``.
    """
    B, C, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    item = q.element_size()
    pool_row = _row_bytes(k_pool, quantized)
    lens = [min(int(n), C) for n in q_len]
    # a slot with no rows this call reads none of its cache
    cached = [min(int(s), nb * bs) if n else 0
              for s, n in zip(q_start, lens)]
    rows = sum(lens)
    tiles = sum(-(-min(s + n, nb * bs) // bs) if n else 0
                for s, n in zip(cached, lens))
    pairs = sum(int(s) * n + n * (n + 1) // 2
                for s, n in zip(q_start, lens))
    bytes_ = ((rows + B * C) * KV * G * D * item   # q rows in, output out
              + 2 * rows * KV * D * item         # k/v_new rows in
              + rows * pool_row                  # the same rows committed
              + sum(cached) * pool_row           # cached K and V rows read
              + 4 * tiles + 8 * B)               # table, q_start, q_len
    return {"bytes": float(bytes_), "flops": 4.0 * pairs * KV * G * D}


def commit_work_terms(k_new: torch.Tensor, k_pool: torch.Tensor, q_len,
                      quantized: bool = False) -> dict:
    """Bytes the commit alone must move, for these inputs: the K/V rows
    below ``q_len`` read once (in k_new's dtype) and written once (in the
    pools' dtype, with their fp32 scales when ``quantized``), one table
    entry a row, ``q_start`` and ``q_len``.  Its arithmetic (an amax and a
    division an element for int8) is not counted: the call is bound by
    bytes and launch latency."""
    B, C, KV, D = k_new.shape
    rows = sum(min(int(n), C) for n in q_len)
    bytes_ = (2 * rows * KV * D * k_new.element_size()
              + rows * _row_bytes(k_pool, quantized) + 4 * rows + 8 * B)
    return {"bytes": float(bytes_), "flops": 0.0}


def prefill_paged_ref(q, k_new, v_new, k_pool, v_pool, block_tables, q_start,
                      q_len=None, k_scale=None, v_scale=None):
    """The reference's functional chunked-prefill oracle: returns (out,
    k_pool', v_pool'), and ``k_scale', v_scale'`` after them with int8
    pools, and leaves the given pools and scales as they are.  ``q_len``
    defaults to the chunk width C.  Rows at or past ``q_len`` come out as
    zeros (the reference leaves them undefined)."""
    B, C = q.shape[:2]
    if q_len is None:
        q_len = torch.full((B,), C, dtype=torch.int32, device=q.device)
    kp, vp = k_pool.clone(), v_pool.clone()
    scales = () if k_scale is None else (k_scale.clone(), v_scale.clone())
    out = flash_prefill_paged_ref(q, k_new, v_new, kp, vp, block_tables,
                                  q_start, q_len, *scales)
    return (out, kp, vp, *scales)


# -- the reference's analytic models, verbatim -----------------------------


def prefill_flops_bytes(B, C, KV, G, D, q_start, dtype_bytes: int = 2) -> dict:
    """Per chunk: every query row attends its causal prefix; traffic = the
    committed chunk write plus the live K+V reads up to each row."""
    live = float(sum(int(s) * C + C * (C + 1) / 2 for s in q_start))
    flops = 4.0 * KV * G * D * live
    bytes_ = 2.0 * KV * D * dtype_bytes * (live + B * C)
    return {"flops": flops, "bytes": bytes_,
            "ai": flops / bytes_ if bytes_ else 0}


def flops_bytes(B, KV, G, D, valid_len, dtype_bytes: int = 2) -> dict:
    """Per decode step: 2*2*H*D flops per live cache token; traffic = live
    K+V reads (the q/output traffic is negligible)."""
    live = float(sum(int(v) for v in valid_len))
    flops = 4.0 * KV * G * D * live
    bytes_ = 2.0 * KV * D * dtype_bytes * live
    return {"flops": flops, "bytes": bytes_,
            "ai": flops / bytes_ if bytes_ else 0}


def issue_counts(valid_len, S: int, block_s: int) -> dict:
    """Predicated vs fixed-width block issues (the SVE lesson at token
    level)."""
    pred = sum(math.ceil(max(int(v), 1) / block_s) for v in valid_len)
    fixed = len(valid_len) * (S // block_s)
    return {"predicated": pred, "fixed": fixed,
            "r_issue": fixed / pred if pred else 0.0}
