#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero):

1. env      torch/CUDA versions and the card's name and power limit.
2. build    nvcc builds of both kernel libraries for sm_90a, in parallel.
3. kernel   each kernel against its plain version at gpt2-124m's and
            qwen3-1.7b's attention shapes, in bf16 and f32: the paged
            flash-decode on shuffled block tables with ragged lengths; the
            chunked prefill (commit + causal attention) with ragged
            q_start and q_len (0, 1 and the whole chunk), pools compared
            through the tables and blocks no table names left untouched.
            Then timings at the serve phases' shapes (median of CUDA-event
            timings) beside each kernel's bound and a library yardstick.
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

H100_BYTES_PER_S = 3.35e12
#: dense peak FLOP/s of one H100 SXM by dtype (NVIDIA's data sheet)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

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
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = terms["bytes"] / H100_BYTES_PER_S * 1e3
    t_ops = terms["flops"] / H100_PEAK_FLOPS[dtype_name] * 1e3
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
    built = kernel.build(force=True)
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
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
