#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernel to its
plain version.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero):

1. env     torch/CUDA versions and the card's name and power limit.
2. build   nvcc build of the paged flash-decode kernel for sm_90a.
3. kernel  the kernel against its plain version on shuffled block tables
           with ragged lengths, at gpt2-124m's and qwen3-1.7b's attention
           shapes, in bf16 and f32; then timings at the serve phase's
           shapes (median of CUDA-event timings).
4. serve   ``repro_torch.launch.serve`` at the full width of gpt2-124m
           (bf16) on the card: every request completes, and the kernel
           runs 12 times (once per layer) per fused step.
   profile a second, shorter drain of that engine under torch.profiler:
           the device's busy time by kernel against the wall time.
5. parity  the same engine on the card and on the CPU, gpt2-124m at full
           width in float32, must give the same greedy streams.

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
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}

SERVE_ARGV = ["--arch", "gpt2-124m", "--no-smoke", "--max-batch", "8",
              "--max-len", "256", "--requests", "16", "--prompt-hi", "64",
              "--max-new", "32", "--device", "cuda"]
PARITY_REQUESTS, PARITY_NEW, PARITY_TOP2_GAP = 4, 8, 1e-3
PROFILE_REQUESTS, PROFILE_NEW = 8, 16


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


def paged_inputs(torch, B, KV, G, D, bs, nb, dtype, valid, seed):
    """Random q and pools, a shuffled block table (block 0 reserved) and
    the given valid lengths, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = 1 + B * nb
    kw = dict(device="cuda", generator=gen)
    q = torch.randn((B, KV, G, D), **kw).to(dtype)
    k_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    v_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    perm = torch.randperm(n_blocks - 1, **kw)[: B * nb] + 1
    bt = perm.reshape(B, nb).to(torch.int32)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, bt, vl


def bound(ref, q, k_pool, bt, valid, dtype_name):
    terms = ref.work_terms(q, k_pool, bt, valid)
    t_bytes = terms["bytes"] / H100_BYTES_PER_S * 1e3
    t_ops = terms["flops"] / H100_PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_kernel(torch, np):
    from repro_torch.kernels.flash_decode import kernel, ref

    B, bs, nb = KERNEL_B, KERNEL_BS, KERNEL_NB
    rng = np.random.default_rng(0)
    valid = rng.integers(1, nb * bs + 1, size=B)
    valid[:4] = (1, bs, bs + 1, nb * bs)  # one row, a block edge, full
    for arch, (KV, G, D) in ARCH_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
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
            bound_ms, bound_by = bound(ref, args[0], args[1], args[3],
                                       valid, name)
            emit({"phase": "kernel", "arch_heads": arch, "dtype": name,
                  "B": B, "KV": KV, "G": G, "D": D, "bs": bs, "nb": nb,
                  "max_abs_err": err, "tol": tol, "ok": bool(ok),
                  "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
            require(ok, f"kernel != plain for {arch} {name}: max abs err "
                        f"{err} over tolerance {tol}")
    return serve_shape_timing(torch, np, kernel, ref)


def serve_shape_timing(torch, np, kernel, ref):
    """Kernel, plain version and one SDPA call at the serve phase's shapes:
    8 slots, 16 blocks of 16 rows, gpt2-124m heads, bf16, with lengths
    drawn over the serve traffic's live range (up to 64 + 32 rows)."""
    import torch.nn.functional as F

    B, bs, nb = 8, 16, 16
    KV, G, D = ARCH_HEADS["gpt2-124m"]
    valid = np.random.default_rng(2).integers(1, 64 + 32 + 1, size=B)
    args = paged_inputs(torch, B, KV, G, D, bs, nb, torch.bfloat16,
                        valid.tolist(), seed=3)
    q, k_pool, v_pool, bt, vl = args
    out = kernel.flash_decode_paged(*args)
    want = ref.flash_decode_paged_ref(*args)
    err = (out.float() - want.float()).abs().max().item()
    tol = TOLERANCE["bfloat16"]
    require(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol),
            f"kernel != plain at serve shapes: max abs err {err}")

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
    bound_ms, bound_by = bound(ref, q, k_pool, bt, valid, "bfloat16")
    row = {
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: kernel.flash_decode_paged(*args)),
        "plain_ms": device_ms(torch,
                              lambda: ref.flash_decode_paged_ref(*args)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(torch, library),
    }
    emit({"phase": "kernel", "shapes": "serve", "B": B, "KV": KV, "G": G,
          "D": D, "bs": bs, "nb": nb, "dtype": "bfloat16",
          "valid_len": valid.tolist(), **row})
    return row


def phase_serve(torch):
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer

    args = serve_cli.parse_args(SERVE_ARGV)
    engine = serve_cli.make_engine(args)
    cfg = engine.cfg
    # finite logits of the right shape from one step on a fresh cache
    B, nb = args.max_batch, args.max_len // args.block_size
    logits, _ = transformer.decode_step_paged(
        engine.params, cfg, torch.ones((B, 1), dtype=torch.int32,
                                       device="cuda"),
        transformer.init_paged_cache(cfg, B, args.max_len, args.block_size,
                                     "cuda"),
        torch.zeros(B, dtype=torch.int32, device="cuda"),
        torch.arange(1, 1 + B * nb, dtype=torch.int32,
                     device="cuda").reshape(B, nb),
        block_size=args.block_size,
    )
    require(tuple(logits.shape) == (B, 1, cfg.vocab_padded),
            f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")

    engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.flash_decode_paged.launches = 0
    report = serve_cli.serve(args, engine)
    torch.cuda.synchronize()
    launches = kernel.flash_decode_paged.launches
    stats = report["stats"]
    reqs = report["requests"]
    require(len(reqs) == args.requests and report["rejected"] == 0,
            f"{len(reqs)} of {args.requests} requests completed")
    require(all(r["new_tokens"] == args.max_new
                and all(0 <= t < cfg.vocab for t in r["tokens"])
                for r in reqs), "a request's tokens are short or invalid")
    require(launches == cfg.n_layers * stats["fused_steps"],
            f"{launches} kernel launches for {stats['fused_steps']} fused "
            f"steps of {cfg.n_layers} layers")
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "requests": stats["requests"], "new_tokens": stats["new_tokens"],
          "fused_steps": stats["fused_steps"], "launches": launches,
          "tok_s": stats["tok_s"], "wall_s": stats["wall_s"],
          "p50_latency_s": stats["p50_latency_s"],
          "ttft_p50_s": stats["ttft_p50_s"],
          "slot_utilization": stats["slot_utilization"],
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return engine, launches


def phase_profile(torch, np, engine):
    """Where a serve step's time goes: a second, shorter drain of the same
    engine under ``torch.profiler`` (device activity only), giving the
    device's busy time by kernel over the drain's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(1)
    first = engine.steps
    for uid in range(PROFILE_REQUESTS):
        prompt = rng.integers(0, engine.cfg.vocab,
                              size=int(rng.integers(4, 65)))
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
    emit({"phase": "profile", "fused_steps": steps, "wall_ms": wall * 1e3,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "step_ms": wall * 1e3 / steps,
          "kernels_per_step": sum(r[2] for r in rows) / steps,
          "top": [{"kernel": k[:80], "device_ms": ms, "calls": n}
                  for k, ms, n in rows[:8]]})


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


def phase_parity(torch, np):
    import repro_torch.configs as configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(configs.get_config("gpt2-124m"),
                              param_dtype="float32",
                              compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 17)))
               .astype(np.int32) for _ in range(PARITY_REQUESTS)]
    streams, params = {}, {}
    for device in ("cuda", "cpu"):
        params[device] = transformer.init_lm(cfg, seed=0, device=device)
        engine = ServeEngine(cfg, params[device], max_batch=4, max_len=64,
                             block_size=16, device=device)
        for uid, p in enumerate(prompts):
            engine.submit(Request(uid=uid, prompt=p.copy(),
                                  max_new_tokens=PARITY_NEW))
        done = engine.run_until_drained()
        streams[device] = [done[u].generated for u in range(len(prompts))]
    gaps = []
    for uid, (a, b) in enumerate(zip(streams["cuda"], streams["cpu"])):
        if a == b:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        tokens = list(prompts[uid]) + a[:i]
        gap = _top2_gap(torch, cfg, params["cpu"], tokens, 16)
        gaps.append({"uid": uid, "index": i, "top2_gap": gap})
        require(gap < PARITY_TOP2_GAP,
                f"request {uid} diverges at token {i} with top-2 gap {gap}")
    emit({"phase": "parity", "arch": cfg.name, "dtype": "float32",
          "requests": len(prompts), "new_tokens": PARITY_NEW,
          "streams_equal": streams["cuda"] == streams["cpu"],
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
    from repro_torch.kernels.flash_decode import kernel

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
    lib, log = kernel.build(force=True)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.time() - t0,
          "library": str(lib.relative_to(ROOT)), "ptxas": ptxas})

    timing = phase_kernel(torch, np)
    engine, launches = phase_serve(torch)
    phase_profile(torch, np, engine)
    phase_parity(torch, np)

    emit({"kernels": [{
        "name": "flash_decode_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_decode/csrc/"
                  "flash_decode_paged.cu",
        "replaces": "src/repro/kernels/flash_decode/kernel.py:256",
        "launches": launches, **timing,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
