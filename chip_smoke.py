#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero):

1. env      torch/CUDA versions and the card's name and power limit.
2. build    nvcc builds of the six kernel libraries for sm_90a, in
            parallel.
3. kernel   each kernel against its plain version at gpt2-124m's and
            qwen3-1.7b's attention shapes, in bf16 and f32: the paged
            flash-decode on shuffled block tables with ragged lengths; the
            chunked prefill (commit + causal attention) with ragged
            q_start and q_len (0, 1 and the whole chunk), pools compared
            through the tables and blocks no table names left untouched.
            Then timings at the serve phases' shapes (median of CUDA-event
            timings) beside each kernel's bound and a library yardstick.
   kernel-hpc  the STREAM, Jacobi2D, GEMM and SpMV kernels against their
            plain versions: odd, misaligned and edge shapes, fp32/bf16
            (and fp16 for STREAM), SpMV rows of 0, 1 and 128 nonzeros.
   timing   the four at full size (STREAM 2^21 x 128 fp32, GEMM 8192^3
            fp32, Jacobi2D 16384^2 fp32, SpMV 2^20 rows of block-ELL width
            128, Zipf nnz up to 64): kernel, plain and library ms beside
            the least time at the H100's peaks.
   analysis the paper's method through ``AnalysisService`` over those
            workloads on the h100 and grace-core models, ROIs timed on the
            card: every HPC kernel launches, and no roofline share is
            above 1.05.
4. serve    ``repro_torch.launch.serve`` at the full width of gpt2-124m
            (bf16): every request completes, and the decode kernel runs 12
            times (once per layer) per fused step.
   profile  a second, shorter drain of that engine under torch.profiler:
            the device's busy time by kernel against the wall time.
5. serve-chunked  the same CLI at the full width of qwen3-1.7b (bf16, all
            28 layers) with chunked prefill: every request completes, and
            the decode and prefill kernels together run 28 times per fused
            step, each at least once.
   profile  the same profile over a second drain of that engine.
6. parity   GPU and CPU engines must give the same greedy streams: gpt2-124m
            at full width token by token, and qwen3-1.7b at full width cut
            to 4 layers, chunked on the card, chunked on the CPU and token
            by token on the card, all in float32.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
``{"ok": true, "device": ...}`` line.  Without CUDA, or outside a checkout,
it prints no result and exits 1.  It imports nothing of JAX and nothing of
the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: the H100 ChipSpec's peak key of each torch dtype name
PEAK_KEY = {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16"}

ARCH_HEADS = {"gpt2-124m": (12, 1, 64), "qwen3-1.7b": (8, 2, 128)}
KERNEL_B, KERNEL_BS, KERNEL_NB = 32, 16, 256
PREFILL_B, PREFILL_C, PREFILL_NB = 8, 64, 64
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}

SERVE_ARGV = ["--arch", "gpt2-124m", "--no-smoke", "--max-batch", "8",
              "--max-len", "256", "--requests", "16", "--prompt-hi", "64",
              "--max-new", "32", "--device", "cuda"]
CHUNKED_ARGV = ["--arch", "qwen3-1.7b", "--no-smoke", "--max-batch", "8",
                "--max-len", "1024", "--block-size", "16", "--requests", "16",
                "--prompt-lo", "64", "--prompt-hi", "512", "--max-new", "32",
                "--prefill-chunk", "64", "--prefill-budget", "256",
                "--device", "cuda"]
PARITY_REQUESTS, PARITY_NEW, PARITY_TOP2_GAP = 4, 8, 1e-3
PROFILE_REQUESTS, PROFILE_NEW = 8, 16
SOURCE_DIR = "src/repro_torch/kernels/flash_decode/csrc/"
TPU_KERNELS = "src/repro/kernels/flash_decode/kernel.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_ms(torch, fn, reps: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn()`` in ms: CUDA events around each call,
    each preceded by a spin of about 1 ms on the card, which keeps it busy
    while the host enqueues the call (tens of us of Python for the
    kernel's wrapper, more for the plain version's dozen ops), so the
    events time the device and not the host.  The L2 stays warm, as in a
    serve step, where the kernel reads K/V rows written just before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_waits(torch, fn, calls: int = 3) -> list:
    """Where each of ``calls`` calls of ``fn`` makes the host wait for the
    card (torch's sync debug mode), as one list of "file:line" per call.
    A timed call should make none, or the CUDA events take in the host's
    time."""
    import warnings

    waits = []
    for _ in range(calls):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        waits.append([f"{Path(w.filename).name}:{w.lineno}" for w in caught
                      if "synchroniz" in str(w.message)])
    return waits


def bound(terms, dtype_name):
    """(least ms the card could take, "bytes" or "operations") at the
    ``repro_torch.core.hw.H100`` peaks (NVIDIA's data sheet)."""
    from repro_torch.core.hw import H100

    t_bytes = terms["bytes"] / H100.hbm_bw * 1e3
    t_ops = terms["flops"] / H100.peak(PEAK_KEY[dtype_name]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def shuffled_tables(torch, gen, B, nb, n_blocks):
    """(B, nb) int32 tables over a random permutation of blocks 1..,
    leaving the rest of the pool (block 0 included) unnamed."""
    perm = torch.randperm(n_blocks - 1, device="cuda", generator=gen)
    return (perm[: B * nb] + 1).reshape(B, nb).to(torch.int32)


# -- decode kernel ------------------------------------------------------------


def paged_inputs(torch, B, KV, G, D, bs, nb, dtype, valid, seed):
    """Random q and pools, a shuffled block table (block 0 reserved) and
    the given valid lengths, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = 1 + B * nb
    kw = dict(device="cuda", generator=gen)
    q = torch.randn((B, KV, G, D), **kw).to(dtype)
    k_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    v_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    bt = shuffled_tables(torch, gen, B, nb, n_blocks)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, bt, vl


def check_decode(torch, np, kernel, ref):
    B, bs, nb = KERNEL_B, KERNEL_BS, KERNEL_NB
    rng = np.random.default_rng(0)
    valid = rng.integers(1, nb * bs + 1, size=B)
    valid[:4] = (1, bs, bs + 1, nb * bs)  # one row, a block edge, full
    for arch, (KV, G, D) in ARCH_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = dtype_name(dtype)
            args = paged_inputs(torch, B, KV, G, D, bs, nb, dtype,
                                valid.tolist(), seed=1)
            out = kernel.flash_decode_paged(*args)
            torch.cuda.synchronize()
            want = ref.flash_decode_paged_ref(*args)
            err = (out.float() - want.float()).abs().max().item()
            tol = TOLERANCE[name]
            ok = torch.allclose(out.float(), want.float(), atol=tol,
                                rtol=tol)
            ms = device_ms(torch, lambda: kernel.flash_decode_paged(*args),
                           reps=50)
            bound_ms, bound_by = bound(
                ref.work_terms(args[0], args[1], args[3], valid), name)
            emit({"phase": "kernel", "kernel": "flash_decode_paged",
                  "arch_heads": arch, "dtype": name,
                  "B": B, "KV": KV, "G": G, "D": D, "bs": bs, "nb": nb,
                  "max_abs_err": err, "tol": tol, "ok": bool(ok),
                  "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
            require(ok, f"decode kernel != plain for {arch} {name}: max abs "
                        f"err {err} over tolerance {tol}")


def decode_timing(torch, np, kernel, ref, arch, nb, max_valid, seed):
    """Kernel, plain version and one SDPA call at a serve phase's shapes:
    8 slots, ``nb`` blocks of 16 rows, the arch's heads, bf16, with
    lengths drawn over the serve traffic's live range."""
    import torch.nn.functional as F

    B, bs = 8, 16
    KV, G, D = ARCH_HEADS[arch]
    valid = np.random.default_rng(seed).integers(1, max_valid + 1, size=B)
    args = paged_inputs(torch, B, KV, G, D, bs, nb, torch.bfloat16,
                        valid.tolist(), seed=seed + 1)
    q, k_pool, v_pool, bt, vl = args
    out = kernel.flash_decode_paged(*args)
    want = ref.flash_decode_paged_ref(*args)
    err = (out.float() - want.float()).abs().max().item()
    tol = TOLERANCE["bfloat16"]
    require(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol),
            f"decode kernel != plain at {arch} serve shapes: max abs err "
            f"{err}")

    # yardstick: one SDPA call on K/V gathered and expanded beforehand
    S = nb * bs
    k = k_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    v = v_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qh = q.reshape(B, KV * G, 1, D)
    mask = (torch.arange(S, device="cuda")[None, :] < vl[:, None])
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (library().reshape(out.shape).float()
               - want.float()).abs().max().item()
    require(lib_err <= 2 * tol, f"SDPA yardstick disagrees: {lib_err}")
    bound_ms, bound_by = bound(ref.work_terms(q, k_pool, bt, valid),
                               "bfloat16")
    row = {
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: kernel.flash_decode_paged(*args)),
        "plain_ms": device_ms(torch,
                              lambda: ref.flash_decode_paged_ref(*args)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(torch, library),
    }
    emit({"phase": "kernel", "kernel": "flash_decode_paged",
          "shapes": f"serve {arch}", "B": B, "KV": KV, "G": G, "D": D,
          "bs": bs, "nb": nb, "dtype": "bfloat16",
          "valid_len": valid.tolist(), **row})
    return row


# -- chunked-prefill kernel ---------------------------------------------------


def prefill_inputs(torch, B, C, KV, G, D, bs, nb, dtype, q_start, q_len,
                   seed, spare=2):
    """Random q, chunk K/V and pools with ``spare`` blocks that no table
    names (besides block 0), a shuffled table, and the given q_start and
    q_len, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = 1 + B * nb + spare
    kw = dict(device="cuda", generator=gen)
    q = torch.randn((B, C, KV, G, D), **kw).to(dtype)
    k_new = torch.randn((B, C, KV, D), **kw).to(dtype)
    v_new = torch.randn((B, C, KV, D), **kw).to(dtype)
    k_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    v_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    bt = shuffled_tables(torch, gen, B, nb, n_blocks)
    ints = [torch.tensor(x, dtype=torch.int32, device="cuda")
            for x in (q_start, q_len)]
    return [q, k_new, v_new, k_pool, v_pool, bt] + ints


def run_prefill(torch, fn, args):
    """``fn`` on private copies of the pools: (out, k_pool, v_pool)."""
    kp, vp = args[3].clone(), args[4].clone()
    out = fn(*args[:3], kp, vp, *args[5:])
    torch.cuda.synchronize()
    return out, kp, vp


def check_prefill(torch, np, kernel, ref):
    """The kernel pair against its plain version: output rows below q_len
    within tolerance and zeros past it, pools bit-equal (a commit is a
    copy), and every block no table names byte-identical to before."""
    B, C, bs, nb = PREFILL_B, PREFILL_C, KERNEL_BS, PREFILL_NB
    rng = np.random.default_rng(4)
    q_len = rng.integers(0, C + 1, size=B)
    q_len[:4] = (0, 1, C, C)
    q_start = rng.integers(0, nb * bs - C + 1, size=B)
    # 0 (fed nothing), 0, a block edge, a chunk across three blocks
    q_start[:4] = (5, 0, bs, 3 * bs - 7)
    for arch, (KV, G, D) in ARCH_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = dtype_name(dtype)
            args = prefill_inputs(torch, B, C, KV, G, D, bs, nb, dtype,
                                  q_start.tolist(), q_len.tolist(), seed=5)
            out, kp, vp = run_prefill(torch, kernel.flash_prefill_paged,
                                      args)
            want, kp_ref, vp_ref = run_prefill(
                torch, ref.flash_prefill_paged_ref, args)
            valid = (torch.arange(C, device="cuda")[None, :]
                     < args[7][:, None])
            err = (out.float() - want.float())[valid].abs().max().item()
            tol = TOLERANCE[name]
            ok_rows = torch.allclose(out.float()[valid],
                                     want.float()[valid], atol=tol, rtol=tol)
            ok_zeros = not out[~valid].any().item()
            bt = args[5].long()
            ok_pools = (torch.equal(kp[bt], kp_ref[bt])
                        and torch.equal(vp[bt], vp_ref[bt]))
            unnamed = torch.ones(kp.shape[0], dtype=torch.bool,
                                 device="cuda")
            unnamed[bt.reshape(-1)] = False
            ok_foreign = (torch.equal(kp[unnamed], args[3][unnamed])
                          and torch.equal(vp[unnamed], args[4][unnamed]))
            emit({"phase": "kernel", "kernel": "flash_prefill_paged",
                  "arch_heads": arch, "dtype": name, "B": B, "C": C,
                  "KV": KV, "G": G, "D": D, "bs": bs, "nb": nb,
                  "q_start": q_start.tolist(), "q_len": q_len.tolist(),
                  "max_abs_err": err, "tol": tol, "rows_ok": bool(ok_rows),
                  "zeros_past_q_len": ok_zeros, "pools_equal": ok_pools,
                  "unnamed_blocks_untouched": ok_foreign})
            require(ok_rows and ok_zeros and ok_pools and ok_foreign,
                    f"prefill kernel != plain for {arch} {name}: rows "
                    f"{ok_rows} (max abs err {err}, tolerance {tol}), zeros "
                    f"{ok_zeros}, pools {ok_pools}, unnamed {ok_foreign}")


def prefill_timing(torch, np, kernel, ref):
    """Kernel pair, plain version and a library yardstick at the chunked
    serve phase's shapes: 8 slots, chunks of 64 rows, qwen3-1.7b heads,
    64 blocks of 16, bf16, q_start drawn over 0..448.  The yardstick is
    one ``index_put_`` commit per pool and one SDPA call with a causal
    mask over K/V gathered beforehand."""
    import torch.nn.functional as F

    B, C, bs, nb = PREFILL_B, PREFILL_C, KERNEL_BS, PREFILL_NB
    KV, G, D = ARCH_HEADS["qwen3-1.7b"]
    q_start = np.random.default_rng(6).integers(0, 449, size=B)
    q_len = np.full(B, C)
    args = prefill_inputs(torch, B, C, KV, G, D, bs, nb, torch.bfloat16,
                          q_start.tolist(), q_len.tolist(), seed=7)
    q, k_new, v_new, k_pool, v_pool, bt, qs, ql = args
    out = kernel.flash_prefill_paged(*args)   # commits into the pools
    want = ref.flash_prefill_paged_ref(*args)
    err = (out.float() - want.float()).abs().max().item()
    tol = TOLERANCE["bfloat16"]
    require(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol),
            f"prefill kernel != plain at serve shapes: max abs err {err}")

    S = nb * bs
    pos = qs.long()[:, None] + torch.arange(C, device="cuda")
    flat = (bt.long().gather(1, pos // bs) * bs + pos % bs).reshape(-1)
    k_flat = k_pool.view(-1, KV, D)
    v_flat = v_pool.view(-1, KV, D)
    k_rows = k_new.reshape(-1, KV, D)
    v_rows = v_new.reshape(-1, KV, D)
    k = k_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    v = v_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qh = q.reshape(B, C, KV * G, D).transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= pos[:, :, None])[:, None]

    def library():
        k_flat.index_put_((flat,), k_rows)
        v_flat.index_put_((flat,), v_rows)
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib = library().transpose(1, 2).reshape(out.shape)
    lib_err = (lib.float() - want.float()).abs().max().item()
    require(lib_err <= 2 * tol, f"SDPA yardstick disagrees: {lib_err}")
    bound_ms, bound_by = bound(
        ref.prefill_work_terms(q, k_pool, bt, q_start, q_len), "bfloat16")

    # the commit rows are selected before the timed calls: selecting them
    # waits for the device, which would put the host's time in the events
    rows = ref.commit_rows(bt, qs, ql, C, bs)
    timed = {"ms": lambda: kernel.flash_prefill_paged(*args),
             "plain_ms": lambda: ref.flash_prefill_paged_ref(*args,
                                                             rows=rows),
             "library_ms": library}
    waits = {key: host_waits(torch, fn) for key, fn in timed.items()}
    require(not any(waits["plain_ms"]),
            f"the timed plain version waits for the device: {waits}")
    row = {"max_abs_err": err,
           **{key: device_ms(torch, fn) for key, fn in timed.items()},
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel", "kernel": "flash_prefill_paged",
          "shapes": "serve qwen3-1.7b chunked", "B": B, "C": C, "KV": KV,
          "G": G, "D": D, "bs": bs, "nb": nb, "dtype": "bfloat16",
          "rows_per_block": kernel.prefill_rows_per_block(C, G, D, bs, nb),
          "q_start": q_start.tolist(), "host_waits": waits, **row})
    return row


# -- HPC kernels: the analysis suite --------------------------------------------

#: full sizes: every array well past the 50 MB L2 (SpMV's x excepted)
STREAM_SHAPE = (1 << 21, 128)  # 2^28 fp32 a array, 1 GiB
STREAM_Q = 3.0
GEMM_N = 8192
JACOBI_N = 16384
SPMV_ROWS, SPMV_MAX_NNZ, SPMV_WIDTH = 1 << 20, 64, 128
HPC_SOURCES = "src/repro_torch/kernels/"
TPU_HPC = "src/repro/kernels/"
STREAM_OPS = ("copy", "scale", "add", "triad")


def hpc_modules():
    from repro_torch.kernels.gemm import kernel as gemm
    from repro_torch.kernels.jacobi2d import kernel as jacobi
    from repro_torch.kernels.spmv import kernel as spmv
    from repro_torch.kernels.stream import kernel as stream

    return gemm, jacobi, spmv, stream


def hpc_entries():
    """{counter name: wrapper} of every HPC kernel entry point."""
    gemm, jacobi, spmv, stream = hpc_modules()
    entries = {f"stream_{op}": getattr(stream, f"stream_{op}")
               for op in STREAM_OPS}
    entries.update(gemm=gemm.gemm, jacobi_step=jacobi.jacobi_step,
                   spmv_blockell=spmv.spmv_blockell,
                   spmv_fixed_width=spmv.spmv_fixed_width)
    return entries


def ulp(torch, x, dtype):
    """Spacing of ``dtype`` numbers at |x| (normal range), as fp32."""
    mantissa = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
    e = torch.floor(torch.log2(x.abs().float().clamp_min(1e-30)))
    return torch.exp2(e - mantissa[dtype])


def exact_close(torch, got, want):
    """STREAM and Jacobi2D: the kernel and its plain version round the same
    fp32 values, so fp32 must be bit-equal and 16-bit within one ulp.
    Returns (max abs err, ok, bit-equal)."""
    err = (got.float() - want.float()).abs()
    tol = 0.0 if got.dtype == torch.float32 else ulp(torch, want, got.dtype)
    return (err.max().item(), bool((err <= tol).all()),
            bool(torch.equal(got, want)))


def gemm_close(torch, got, want):
    """fp32 sums along K in another order: 1e-5 * max|want|, plus one ulp
    of the result in bf16 (one rounding at the flush)."""
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * want.float().abs().max()
    if got.dtype == torch.bfloat16:
        tol = tol + ulp(torch, want, got.dtype)
    return err.max().item(), bool((err <= tol).all())


def spmv_close(torch, got, want, scale):
    """Row sums in another order: 1e-6 of the row's sum of |terms|
    (``scale``; an fp32 sum of 128 lanes reordered as a tree is off by at
    most about log2(128) + 1 roundings of it), plus rtol 1e-5 in fp32 or
    one ulp of the result in bf16."""
    err = (got.float() - want.float()).abs()
    tol = 1e-6 * scale.float()
    tol = tol + (1e-5 * want.float().abs() if got.dtype == torch.float32
                 else ulp(torch, want, got.dtype))
    return err.max().item(), bool((err <= tol).all())


def spmv_scale(ref, values, cols, nnz, x, **kw):
    """Each row's sum of |terms|, by the plain version."""
    return ref.spmv_plain(values.abs(), cols, nnz, x.abs(), **kw)


def check_hpc(torch, np):
    """Each HPC kernel against its plain version on the card: STREAM in
    fp32/bf16/fp16 on aligned, odd and misaligned arrays (the 16-byte and
    the one-element paths); Jacobi2D in fp32/bf16 on odd sizes and grids
    with H or W below 3; GEMM in fp32/bf16 on sizes no tile divides; SpMV
    in fp32/bf16, predicated (repeat 1, 4, 20) and fixed width, with rows
    of 0, 1 and 128 nonzeros, and predicated lanes poisoned with NaN."""
    from repro_torch.kernels.spmv import ref as spmv_ref

    gemm, jacobi, spmv, stream = hpc_modules()
    gen = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16

    def randn(shape, dtype):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    def report(kernel, cases):
        bad = [c for c in cases if not c["ok"]]
        emit({"phase": "kernel-hpc", "kernel": kernel, "cases": len(cases),
              "max_abs_err": max(c["max_abs_err"] for c in cases),
              "bit_equal": all(c.get("bit_equal", False) for c in cases),
              "failed": bad})
        require(not bad, f"{kernel} kernel != plain: {bad}")

    cases = []
    for dtype in (f32, bf16, f16):
        for rows, width, offset in ((64, 128, 0), (37, 100, 0), (37, 100, 1)):
            n = rows * width
            a, b = (randn((n + offset,), dtype)[offset:].view(rows, width)
                    for _ in range(2))
            for op in STREAM_OPS:
                args = {"copy": (a,), "scale": (a, 0.3), "add": (a, b),
                        "triad": (a, b, 0.3)}[op]
                got = getattr(stream, f"stream_{op}")(*args, block_rows=rows)
                want = getattr(stream, f"stream_{op}_plain")(
                    *args, block_rows=rows)
                torch.cuda.synchronize()
                err, ok, bit = exact_close(torch, got, want)
                cases.append({"op": op, "dtype": dtype_name(dtype),
                              "shape": [rows, width], "offset": offset,
                              "max_abs_err": err, "ok": ok, "bit_equal": bit})
    report("stream", cases)

    cases = []
    for dtype in (f32, bf16):
        for H, W in ((1, 5), (2, 7), (7, 2), (3, 3), (67, 1001), (300, 129)):
            u = randn((H, W), dtype)
            got = jacobi.jacobi_step(u, block_rows=H)
            want = jacobi.jacobi_step_plain(u, block_rows=H)
            torch.cuda.synchronize()
            err, ok, bit = exact_close(torch, got, want)
            ring = bool(torch.equal(got[[0, -1]], u[[0, -1]])
                        and torch.equal(got[:, [0, -1]], u[:, [0, -1]]))
            cases.append({"dtype": dtype_name(dtype), "shape": [H, W],
                          "max_abs_err": err, "ok": ok and ring,
                          "bit_equal": bit, "ring_passes": ring})
    report("jacobi_step", cases)

    cases = []
    for dtype in (f32, bf16):
        for M, N, K in ((1, 1, 1), (100, 130, 70), (257, 129, 33),
                        (128, 128, 256)):
            x, y = randn((M, K), dtype), randn((K, N), dtype)
            got = gemm.gemm(x, y, bm=M, bn=N, bk=K)
            want = gemm.gemm_plain(x, y, bm=M, bn=N, bk=K)
            torch.cuda.synchronize()
            err, ok = gemm_close(torch, got, want)
            cases.append({"dtype": dtype_name(dtype), "shape": [M, N, K],
                          "max_abs_err": err, "ok": ok})
    report("gemm", cases)

    cases = []
    for dtype in (f32, bf16):
        vals, cols, nnz = spmv_ref.make_problem(
            1000, 3000, row_block=8, max_nnz=64, width_pad=128, dtype=dtype,
            generator=gen, device="cuda")
        nnz[0, :3] = torch.tensor([0, 1, 128], dtype=torch.int32)
        vals[0, 0] = 0
        vals[0, 1, 1:] = 0
        vals[0, 2] = randn((128,), dtype)
        x = randn((3000,), dtype)
        lane = torch.arange(128, device="cuda")
        poisoned = torch.where(lane < nnz[..., None], vals,
                               torch.tensor(float("nan"), dtype=dtype,
                                            device="cuda"))
        for repeat in (1, 4, 20):
            args = (vals, cols, nnz, x)
            got = spmv.spmv_blockell(*args, repeat=repeat)
            want = spmv.spmv_blockell_plain(*args, repeat=repeat)
            inert = spmv.spmv_blockell(poisoned, cols, nnz, x, repeat=repeat)
            torch.cuda.synchronize()
            err, ok = spmv_close(torch, got, want,
                                 spmv_scale(spmv_ref, *args, repeat=repeat))
            cases.append({"variant": "predicated", "repeat": repeat,
                          "dtype": dtype_name(dtype), "max_abs_err": err,
                          "ok": ok and bool(torch.equal(inert, got)),
                          "poisoned_lanes_inert": bool(torch.equal(inert,
                                                                   got)),
                          "row_nnz_0_1_128": got[:3].float().tolist()})
        got = spmv.spmv_fixed_width(vals, cols, nnz, x)
        want = spmv.spmv_fixed_width_plain(vals, cols, nnz, x)
        torch.cuda.synchronize()
        err, ok = spmv_close(torch, got, want,
                             spmv_scale(spmv_ref, vals, cols, nnz, x,
                                        predicated=False))
        cases.append({"variant": "fixed_width", "dtype": dtype_name(dtype),
                      "max_abs_err": err, "ok": ok})
    report("spmv", cases)


def hpc_problems(torch):
    """The full-size inputs of the four kernels, made on the card from
    seeded generators."""
    from repro_torch.kernels.spmv import ref as spmv_ref

    gen = torch.Generator(device="cuda").manual_seed(21)
    kw = dict(device="cuda", generator=gen)
    vals, cols, nnz = spmv_ref.make_problem(
        SPMV_ROWS, SPMV_ROWS, row_block=8, max_nnz=SPMV_MAX_NNZ,
        width_pad=SPMV_WIDTH, generator=gen, device="cuda")
    return {
        "stream": (torch.randn(STREAM_SHAPE, **kw),
                   torch.randn(STREAM_SHAPE, **kw)),
        "gemm": (torch.randn((GEMM_N, GEMM_N), **kw),
                 torch.randn((GEMM_N, GEMM_N), **kw)),
        "jacobi": (torch.randn((JACOBI_N, JACOBI_N), **kw),),
        "spmv": (vals, cols, nnz, torch.randn((SPMV_ROWS,), **kw)),
    }


def hpc_timing(torch, problems):
    """Each kernel at full size: held against its plain version, then
    device ms (median of CUDA events) of the kernel, the plain version and
    one PyTorch library call computing the same function, beside the
    least time at the H100's peaks.  Returns {kernel: row}."""
    from repro_torch.kernels.gemm import ref as gemm_ref
    from repro_torch.kernels.jacobi2d import ref as jacobi_ref
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.stream import ref as stream_ref

    gemm, jacobi, spmv, stream = hpc_modules()
    rows = {}

    a, b = problems["stream"]
    c = torch.empty_like(a)
    q = STREAM_Q
    library = {"copy": lambda: c.copy_(a),
               "scale": lambda: torch.mul(a, q, out=c),
               "add": lambda: torch.add(a, b, out=c),
               "triad": lambda: torch.add(a, b, alpha=q, out=c)}
    for op in STREAM_OPS:
        args = {"copy": (a,), "scale": (a, q), "add": (a, b),
                "triad": (a, b, q)}[op]
        kern = getattr(stream, f"stream_{op}")
        plain = getattr(stream, f"stream_{op}_plain")
        want = plain(*args)
        err, ok, bit = exact_close(torch, kern(*args), want)
        require(ok, f"stream {op} kernel != plain at full size: {err}")
        library[op]()
        require(torch.allclose(c, want, rtol=1e-6, atol=1e-6),
                f"stream {op} library yardstick disagrees")
        del want
        bound_ms, bound_by = bound(stream_ref.work_terms(op, a), "float32")
        rows[f"stream_{op}"] = {
            "max_abs_err": err, "bit_equal": bit,
            "ms": device_ms(torch, lambda: kern(*args), reps=30),
            "plain_ms": device_ms(torch, lambda: plain(*args), reps=30),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(torch, library[op], reps=30)}
        emit({"phase": "timing", "kernel": f"stream_{op}",
              "shape": list(STREAM_SHAPE), "dtype": "float32",
              **rows[f"stream_{op}"]})
    del c

    x, y = problems["gemm"]
    want = gemm.gemm_plain(x, y)
    err, ok = gemm_close(torch, gemm.gemm(x, y), want)
    require(ok, f"gemm kernel != plain at full size: {err}")
    lib_err, lib_ok = gemm_close(torch, torch.matmul(x, y), want)
    require(lib_ok, f"gemm library yardstick disagrees: {lib_err}")
    del want
    bound_ms, bound_by = bound(gemm_ref.work_terms(x, y), "float32")
    rows["gemm"] = {
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: gemm.gemm(x, y), reps=5, warmup=2),
        "plain_ms": device_ms(torch, lambda: gemm.gemm_plain(x, y), reps=5,
                              warmup=2),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(torch, lambda: torch.matmul(x, y), reps=5,
                                warmup=2)}
    emit({"phase": "timing", "kernel": "gemm", "shape": [GEMM_N] * 3,
          "dtype": "float32", "tf32": torch.backends.cuda.matmul.allow_tf32,
          **rows["gemm"]})

    (u,) = problems["jacobi"]
    err, ok, bit = exact_close(torch, jacobi.jacobi_step(u),
                               jacobi.jacobi_step_plain(u))
    require(ok, f"jacobi kernel != plain at full size: {err}")
    bound_ms, bound_by = bound(jacobi_ref.work_terms(u), "float32")
    rows["jacobi_step"] = {
        "max_abs_err": err, "bit_equal": bit,
        "ms": device_ms(torch, lambda: jacobi.jacobi_step(u), reps=30),
        "plain_ms": device_ms(torch, lambda: jacobi.jacobi_step_plain(u),
                              reps=30),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit({"phase": "timing", "kernel": "jacobi_step",
          "shape": [JACOBI_N, JACOBI_N], "dtype": "float32",
          **rows["jacobi_step"]})

    vals, cols, nnz, xs = problems["spmv"]
    width = vals.shape[-1]
    live = torch.arange(width, device="cuda") < nnz[..., None]
    counts = nnz.reshape(-1).long().clamp(0, width)
    crow = torch.zeros(counts.numel() + 1, dtype=torch.int64, device="cuda")
    crow[1:] = counts.cumsum(0)
    csr = torch.sparse_csr_tensor(crow, cols[live].long(), vals[live],
                                  size=(SPMV_ROWS, SPMV_ROWS))
    xcol = xs[:, None]
    for variant, kern, plain, predicated in (
            ("spmv_blockell", spmv.spmv_blockell, spmv.spmv_blockell_plain,
             True),
            ("spmv_fixed_width", spmv.spmv_fixed_width,
             spmv.spmv_fixed_width_plain, False)):
        want = plain(vals, cols, nnz, xs)
        scale = spmv_scale(spmv_ref, vals, cols, nnz, xs,
                           predicated=predicated)
        err, ok = spmv_close(torch, kern(vals, cols, nnz, xs), want, scale)
        require(ok, f"{variant} kernel != plain at full size: {err}")
        lib_err, lib_ok = spmv_close(
            torch, torch.sparse.mm(csr, xcol)[:, 0], want, scale)
        require(lib_ok, f"spmv library yardstick disagrees: {lib_err}")
        bound_ms, bound_by = bound(
            spmv_ref.work_terms(vals, nnz, xs, predicated=predicated),
            "float32")
        rows[variant] = {
            "max_abs_err": err,
            "ms": device_ms(torch, lambda: kern(vals, cols, nnz, xs),
                            reps=50),
            "plain_ms": device_ms(torch, lambda: plain(vals, cols, nnz, xs),
                                  reps=30),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(torch,
                                    lambda: torch.sparse.mm(csr, xcol),
                                    reps=50)}
        emit({"phase": "timing", "kernel": variant,
              "rows": SPMV_ROWS, "width": width, "max_nnz": SPMV_MAX_NNZ,
              "nnz": int(counts.sum()), "dtype": "float32", **rows[variant]})
    return rows


def hpc_workloads(torch, problems):
    """The four kernels at full size as ad-hoc Workloads, with the
    reference's analytic models (STREAM's four ops, and SpMV's predicated
    and fixed-width entry points), and the least work of each call."""
    from repro_torch.analysis import Workload
    from repro_torch.kernels import registry
    from repro_torch.kernels.gemm import ref as gemm_ref
    from repro_torch.kernels.jacobi2d import ref as jacobi_ref
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.stream import ref as stream_ref

    out = []
    a, b = problems["stream"]
    for op in STREAM_OPS:
        fb = stream_ref.flops_bytes(op, a.numel(), 4)
        args = {"copy": (a,), "scale": (a, STREAM_Q), "add": (a, b),
                "triad": (a, b, STREAM_Q)}[op]
        out.append((Workload(
            name=f"full/stream-{op}", fn=registry.get_kernel(f"stream-{op}"),
            args=args, flops=fb["flops"], hbm_bytes=fb["bytes"],
            problem="2^21x128"), stream_ref.work_terms(op, a)))
    x, y = problems["gemm"]
    fb = gemm_ref.flops_bytes(GEMM_N, GEMM_N, GEMM_N, 4)
    out.append((Workload(name="full/gemm", fn=registry.GEMM, args=(x, y),
                         flops=fb["flops"], hbm_bytes=fb["bytes"],
                         problem=f"{GEMM_N}^3"),
                gemm_ref.work_terms(x, y)))
    (u,) = problems["jacobi"]
    fb = jacobi_ref.flops_bytes(JACOBI_N, JACOBI_N, 4)
    out.append((Workload(name="full/jacobi2d", fn=registry.JACOBI_STEP,
                         args=(u,), flops=fb["flops"], hbm_bytes=fb["bytes"],
                         problem=f"{JACOBI_N}^2"),
                jacobi_ref.work_terms(u)))
    vals, cols, nnz, xs = problems["spmv"]
    for name, fn, entries, predicated in (
            ("full/spmv", registry.SPMV,
             float(nnz.clamp(0, vals.shape[-1]).sum()), True),
            ("full/spmv-fixed-width", registry.SPMV_FIXED,
             float(vals.numel()), False)):
        out.append((Workload(
            name=name, fn=fn, args=(vals, cols, nnz, xs),
            flops=2.0 * entries, hbm_bytes=entries * 12.0,
            gather_bytes=entries * 4.0, problem="2^20^2 zipf"),
            spmv_ref.work_terms(vals, nnz, xs, predicated=predicated)))
    return out


def phase_analysis(torch, problems):
    """The paper's method through its service entry point: the full-size
    workloads on the h100 and grace-core models, each ROI timed on the card
    (jobs 1).  The launch counts are set to 0 just before the drain and
    read just after: every HPC kernel runs.  The share of the H100's
    roofline attained (least time for the least bytes or flops, over
    wall_s) above 1.05 fails the run."""
    from repro_torch.serve.analysis_service import AnalysisService

    workloads = hpc_workloads(torch, problems)
    svc = AnalysisService(max_batch=8, jobs=1, device="cuda")
    for wl, _ in workloads:
        svc.submit(wl, chips=("h100", "grace-core"), time_roi=True)
    entries = hpc_entries()
    for fn in entries.values():
        fn.launches = 0
    torch.cuda.synchronize()
    svc.run_until_drained()
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in entries.items()}
    report = svc.report()
    require(report["service"]["errors"] == 0,
            f"analysis errors: {[r['error'] for r in report['requests']]}")
    require(report["service"]["cells"] == 2 * len(workloads),
            f"{report['service']['cells']} cells")
    require(all(n > 0 for n in counts.values()),
            f"a kernel of the path never launched: {counts}")
    least = {wl.name: terms for wl, terms in workloads}
    cells = []
    for req in svc.completed.values():
        for res in req.results:
            wall = res.wall_s
            require(wall is not None and wall > 0, f"{res.workload} wall_s")
            bound_ms, bound_by = bound(least[res.workload], "float32")
            share = bound_ms / 1e3 / wall
            cells.append({"workload": res.workload, "chip": res.chip,
                          "class": int(res.perf_class),
                          "class_name": res.perf_class.name,
                          "ai": res.ai, "knee": res.ai_inflection,
                          "region": res.bound, "vb": res.vb,
                          "r_ins": res.r_ins, "wall_s": wall,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "roofline_share": share})
            require(share <= 1.05,
                    f"{res.workload}: {share:.3f} of the H100 roofline, "
                    f"above 1.05")
    emit({"phase": "analysis", "cells": cells, "launches": counts,
          "waves": report["service"]["waves"],
          "wall_s": report["service"]["wall_s"]})
    return counts


# -- serving ------------------------------------------------------------------


def reset_counts(kernel) -> None:
    kernel.flash_decode_paged.launches = 0
    kernel.flash_prefill_paged.launches = 0


def read_counts(kernel) -> dict:
    return {"flash_decode_paged": kernel.flash_decode_paged.launches,
            "flash_prefill_paged": kernel.flash_prefill_paged.launches}


def check_first_step(torch, engine, args) -> None:
    """Finite logits of the right shape from one step on a fresh cache: a
    decode step, and with chunked prefill a chunk step of full width."""
    from repro_torch.models import transformer

    cfg = engine.cfg
    B, nb = args.max_batch, args.max_len // args.block_size
    cache = transformer.init_paged_cache(cfg, B, args.max_len,
                                         args.block_size, "cuda")
    bt = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                      device="cuda").reshape(B, nb)
    zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
    logits, _ = transformer.decode_step_paged(
        engine.params, cfg, torch.ones((B, 1), dtype=torch.int32,
                                       device="cuda"),
        cache, zeros, bt, block_size=args.block_size)
    checks = [logits]
    if args.prefill_chunk > 1:
        C = args.prefill_chunk
        lens = torch.full((B,), C, dtype=torch.int32, device="cuda")
        logits, _ = transformer.prefill_step_paged(
            engine.params, cfg, torch.ones((B, C), dtype=torch.int32,
                                           device="cuda"),
            cache, zeros + 1, bt, lens, block_size=args.block_size,
            last_rows=lens - 1)
        checks.append(logits)
    for logits in checks:
        require(tuple(logits.shape) == (B, 1, cfg.vocab_padded),
                f"logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), "non-finite logits")


def phase_serve(torch, argv, phase):
    """Serve the CLI's traffic on the card.  The launch counts are set to
    0 just before the drain and read just after: every layer of every
    fused step runs exactly one of the kernels, and each kernel the path
    uses runs at least once."""
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.parse_args(argv)
    t0 = time.time()
    engine = serve_cli.make_engine(args)
    init_s = time.time() - t0
    cfg = engine.cfg
    check_first_step(torch, engine, args)
    engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel)
    report = serve_cli.serve(args, engine)
    torch.cuda.synchronize()
    counts = read_counts(kernel)
    stats = report["stats"]
    reqs = report["requests"]
    require(len(reqs) == args.requests and report["rejected"] == 0,
            f"{len(reqs)} of {args.requests} requests completed")
    require(all(r["new_tokens"] == args.max_new
                and all(0 <= t < cfg.vocab for t in r["tokens"])
                for r in reqs), "a request's tokens are short or invalid")
    steps = stats["fused_steps"]
    require(sum(counts.values()) == cfg.n_layers * steps,
            f"{counts} kernel launches for {steps} fused steps of "
            f"{cfg.n_layers} layers")
    used = (["flash_decode_paged", "flash_prefill_paged"]
            if args.prefill_chunk > 1 else ["flash_decode_paged"])
    require(all(counts[k] > 0 for k in used),
            f"a kernel of the path never launched: {counts}")
    emit({"phase": phase, "arch": cfg.name, "dtype": cfg.compute_dtype,
          "layers": cfg.n_layers, "prefill_chunk": args.prefill_chunk,
          "prefill_budget": args.prefill_budget,
          "requests": stats["requests"], "new_tokens": stats["new_tokens"],
          "prompt_tokens": sum(r["prompt_len"] for r in reqs),
          "fused_steps": steps, "launches": counts,
          "tok_s": stats["tok_s"], "wall_s": stats["wall_s"],
          "p50_latency_s": stats["p50_latency_s"],
          "p95_latency_s": stats["p95_latency_s"],
          "ttft_p50_s": stats["ttft_p50_s"],
          "ttft_p50_steps": stats["ttft_p50_steps"],
          "slot_utilization": stats["slot_utilization"],
          "init_s": init_s,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return engine, counts


def phase_profile(torch, np, engine, phase, prompt_lo, prompt_hi):
    """Where a serve step's time goes: a second, shorter drain of the same
    engine under ``torch.profiler`` (device activity only), giving the
    device's busy time by kernel over the drain's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(1)
    first = engine.steps
    for uid in range(PROFILE_REQUESTS):
        prompt = rng.integers(0, engine.cfg.vocab,
                              size=int(rng.integers(prompt_lo,
                                                    prompt_hi + 1)))
        engine.submit(Request(uid=1000 + uid, prompt=prompt.astype(np.int32),
                              max_new_tokens=PROFILE_NEW))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    require(busy_ms > 0, "the profiler saw no device time")
    steps = engine.steps - first
    emit({"phase": phase, "arch": engine.cfg.name, "fused_steps": steps,
          "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "step_ms": wall * 1e3 / steps,
          "kernels_per_step": sum(r[2] for r in rows) / steps,
          "top": [{"kernel": k[:80], "device_ms": ms, "calls": n}
                  for k, ms, n in rows[:10]]})


# -- parity -------------------------------------------------------------------


def _top2_gap(torch, cfg, params, tokens, block_size):
    """Top-2 logit gap of the next token after ``tokens``, on the CPU."""
    from repro_torch.models import transformer

    max_len = -(-len(tokens) // block_size) * block_size
    cache = transformer.init_paged_cache(cfg, 1, max_len, block_size, "cpu")
    bt = torch.arange(1, 1 + max_len // block_size,
                      dtype=torch.int32)[None, :]
    for t, tok in enumerate(tokens):
        logits, cache = transformer.decode_step_paged(
            params, cfg, torch.tensor([[tok]], dtype=torch.int32), cache,
            torch.tensor([t], dtype=torch.int32), bt, block_size=block_size)
    top = logits[0, 0, :cfg.vocab].topk(2).values
    return float(top[0] - top[1])


def _drain(cfg, params, prompts, device, **kw):
    from repro_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(cfg, params, device=device, **kw)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=p.copy(),
                              max_new_tokens=PARITY_NEW))
    done = engine.run_until_drained()
    return [done[u].generated for u in range(len(prompts))]


def _divergences(torch, cfg, cpu_params, prompts, ref, other, block_size):
    """Where ``other`` leaves ``ref``, the top-2 gap there, which must be
    under PARITY_TOP2_GAP (a near tie that fp32 rounding may flip)."""
    gaps = []
    for uid, (a, b) in enumerate(zip(ref, other)):
        if a == b:
            continue
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        tokens = list(prompts[uid]) + a[:i]
        gap = _top2_gap(torch, cfg, cpu_params, tokens, block_size)
        gaps.append({"uid": uid, "index": i, "top2_gap": gap})
        require(gap < PARITY_TOP2_GAP,
                f"request {uid} diverges at token {i} with top-2 gap {gap}")
    return gaps


def phase_parity(torch, np):
    import repro_torch.configs as configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config("gpt2-124m"),
                              param_dtype="float32",
                              compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 17)))
               .astype(np.int32) for _ in range(PARITY_REQUESTS)]
    params = {d: transformer.init_lm(cfg, seed=0, device=d)
              for d in ("cuda", "cpu")}
    kw = dict(max_batch=4, max_len=64, block_size=16)
    streams = {d: _drain(cfg, params[d], prompts, d, **kw)
               for d in ("cuda", "cpu")}
    gaps = _divergences(torch, cfg, params["cpu"], prompts, streams["cpu"],
                        streams["cuda"], 16)
    emit({"phase": "parity", "arch": cfg.name, "dtype": "float32",
          "requests": len(prompts), "new_tokens": PARITY_NEW,
          "streams_equal": streams["cuda"] == streams["cpu"],
          "divergences": gaps})


def phase_parity_chunked(torch, np):
    """qwen3-1.7b at full width cut to 4 layers, float32: chunked on the
    card (both kernels), chunked on the CPU (both plain versions) and
    token by token on the card must give the same greedy streams, up to
    near ties."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), n_layers=4,
                              param_dtype="float32",
                              compute_dtype="float32")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(20, 81)))
               .astype(np.int32) for _ in range(PARITY_REQUESTS)]
    params = {d: transformer.init_lm(cfg, seed=0, device=d)
              for d in ("cuda", "cpu")}
    kw = dict(max_batch=4, max_len=96, block_size=16)
    chunked = dict(kw, prefill_chunk=16, prefill_budget=32)
    reset_counts(kernel)
    streams = {"cuda_chunked": _drain(cfg, params["cuda"], prompts, "cuda",
                                      **chunked)}
    counts = read_counts(kernel)
    require(all(n > 0 for n in counts.values()),
            f"the chunked parity run skipped a kernel: {counts}")
    streams["cpu_chunked"] = _drain(cfg, params["cpu"], prompts, "cpu",
                                    **chunked)
    streams["cuda_token"] = _drain(cfg, params["cuda"], prompts, "cuda",
                                   **kw)
    gaps = {name: _divergences(torch, cfg, params["cpu"], prompts,
                               streams["cpu_chunked"], streams[name], 16)
            for name in ("cuda_chunked", "cuda_token")}
    emit({"phase": "parity-chunked", "arch": cfg.name, "layers": 4,
          "dtype": "float32", "requests": len(prompts),
          "prompt_lens": [len(p) for p in prompts],
          "new_tokens": PARITY_NEW, "launches": counts,
          "streams_equal": {name: s == streams["cpu_chunked"]
                            for name, s in streams.items()},
          "divergences": gaps})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    import repro_torch
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import kernel, ref

    require(Path(repro_torch.__file__).resolve().is_relative_to(SRC),
            f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    resolve_device("cuda")  # also switches TF32 off
    card = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.time()
    built = build.build(force=True)
    emit({"phase": "build", "seconds": time.time() - t0, "libraries": {
        name: {"library": str(lib.relative_to(ROOT)),
               "ptxas": [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, (lib, log) in built.items()}})

    check_decode(torch, np, kernel, ref)
    decode_timing(torch, np, kernel, ref, "gpt2-124m", 16, 64 + 32, seed=2)
    decode_row = decode_timing(torch, np, kernel, ref, "qwen3-1.7b", 64,
                               512 + 32, seed=8)
    check_prefill(torch, np, kernel, ref)
    prefill_row = prefill_timing(torch, np, kernel, ref)

    check_hpc(torch, np)
    problems = hpc_problems(torch)
    hpc_rows = hpc_timing(torch, problems)
    hpc_counts = phase_analysis(torch, problems)
    del problems
    torch.cuda.empty_cache()

    engine, _ = phase_serve(torch, SERVE_ARGV, "serve")
    phase_profile(torch, np, engine, "profile", 4, 64)
    del engine
    engine, counts = phase_serve(torch, CHUNKED_ARGV, "serve-chunked")
    phase_profile(torch, np, engine, "profile-chunked", 64, 256)
    del engine
    torch.cuda.empty_cache()
    phase_parity(torch, np)
    phase_parity_chunked(torch, np)

    emit({"kernels": [
        {"name": "flash_decode_paged", "route": "cuda",
         "source": SOURCE_DIR + "flash_decode_paged.cu",
         "replaces": f"{TPU_KERNELS}:256",
         "launches": counts["flash_decode_paged"], **decode_row},
        {"name": "flash_prefill_paged", "route": "cuda",
         "source": SOURCE_DIR + "flash_prefill_paged.cu",
         "replaces": f"{TPU_KERNELS}:573,620",
         "launches": counts["flash_prefill_paged"], **prefill_row},
        {"name": "stream", "op": "triad", "route": "cuda",
         "source": HPC_SOURCES + "stream/csrc/stream.cu",
         "replaces": f"{TPU_HPC}stream/kernel.py:38",
         "launches": sum(hpc_counts[f"stream_{op}"] for op in STREAM_OPS),
         **hpc_rows["stream_triad"]},
        {"name": "gemm", "route": "cuda",
         "source": HPC_SOURCES + "gemm/csrc/gemm.cu",
         "replaces": f"{TPU_HPC}gemm/kernel.py:56",
         "launches": hpc_counts["gemm"], **hpc_rows["gemm"]},
        {"name": "spmv_blockell", "route": "cuda",
         "source": HPC_SOURCES + "spmv/csrc/spmv.cu",
         "replaces": f"{TPU_HPC}spmv/kernel.py:52,82",
         "launches": (hpc_counts["spmv_blockell"]
                      + hpc_counts["spmv_fixed_width"]),
         "fixed_width_ms": hpc_rows["spmv_fixed_width"]["ms"],
         **hpc_rows["spmv_blockell"]},
        {"name": "jacobi_step", "route": "cuda",
         "source": HPC_SOURCES + "jacobi2d/csrc/jacobi2d.cu",
         "replaces": f"{TPU_HPC}jacobi2d/kernel.py:52",
         "launches": hpc_counts["jacobi_step"], **hpc_rows["jacobi_step"]},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
