"""Serving CLI of the port: init a model, serve sampled requests.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-124m \\
        --no-smoke --max-batch 8 --requests 16 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --no-smoke --max-batch 8 --max-len 1024 --prompt-lo 64 \\
        --prompt-hi 512 --max-new 32 --prefill-chunk 64 --prefill-budget 256
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --kv-dtype int8 --share-prefixes --shared-prefix-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --mesh 1x2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-v2-lite-16b --prefill-chunk 8 --prefill-budget 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --draft gpt2-124m --spec-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --temperature 0.8 --top-k 20 --sample-seed 7
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --scheduler wave

The same defaults, prompt sampling (``np.random.default_rng(seed)``),
summary lines and ``--out`` report fields as ``repro.launch.serve``, on
``--device cuda`` (the default) or ``cpu``.  The weights come from the
port's own seeded init, so the token streams differ from the reference
CLI's; the tests hold the engine to the reference's streams with the
reference's weights.  ``--kv-dtype bf16/int8`` stores the KV pools in bf16
or int8 with per-row scales; ``--share-prefixes`` maps identical prompt
prefixes onto shared pool blocks with copy-on-write (``--shared-prefix-len
N`` samples traffic with a common N-token prefix), and the summary then
prints the dedup line.  ``--mesh DxM`` serves tensor-parallel over
``D*M`` ranks that it spawns (:func:`repro_torch.launch.mesh.spawn`):
rank 0 prints the summary, with a line for the mesh's backend and every
rank's collectives, and the report carries ``mesh`` and ``mesh_ranks``.
``--draft ARCH --spec-k N`` serves with speculative decoding (the draft's
weights are drawn with the target's ``--seed``, so ``--draft`` of the
served arch is self-speculation), and ``--temperature T --top-k K
--sample-seed S`` samples each request's canonical stream.
``--scheduler wave`` serves in lockstep waves over the dense cache (the
reference's golden baseline; the summary's prefix is ``[wave]``).
Options the port does not serve yet are refused.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import repro_torch.configs as configs
from repro_torch.kernels.flash_decode import kernel
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.serve.engine import (SCHEDULERS, Request, RequestTooLong,
                                      ServeEngine)

#: the serve path's kernel wrappers, each with its launch count
SERVE_KERNELS = ("flash_decode_paged", "flash_decode_paged_sharded",
                 "flash_prefill_paged", "commit_paged", "flash_decode")


def _counters(engine: ServeEngine) -> dict:
    """This rank's kernel launches and collectives' counters so far."""
    out = {name: getattr(kernel, name).launches for name in SERVE_KERNELS}
    out["decode_commits"] = kernel.flash_decode_paged.commit_launches
    if engine.mesh is not None:
        out.update(engine.mesh.comm.counters())
    return out


def _rank_row(engine: ServeEngine, before: dict, wall_s: float) -> dict:
    """What this rank did while serving: launches and collectives since
    ``before``, its backend, device and local KV heads, its wall time."""
    mesh = engine.mesh
    wk = next((p["attn"]["wk"]["w"] for p in engine.params["layers"]
               if "attn" in p), None)
    new = sum(len(r.generated) for r in engine.completed.values())
    return {"rank": mesh.rank, "coords": [mesh.data_index,
                                          mesh.model_index],
            "backend": mesh.backend, "device": str(mesh.device),
            "local_kv_heads": (0 if wk is None
                               else wk.shape[1] // engine.cfg.head_dim),
            **{k: v - before[k] for k, v in _counters(engine).items()},
            "wall_s": wall_s, "tok_s": new / wall_s if wall_s > 0 else 0.0}


def build_report(args: argparse.Namespace, engine: ServeEngine,
                 rejections: list = (), ranks=None) -> dict:
    """Machine-readable serve report (the fields of the reference's, and
    under a mesh its backend and every rank's row)."""
    return {
        "kind": "serve_report",
        "arch": args.arch,
        "scheduler": engine.scheduler,
        "max_batch": engine.max_batch,
        "max_len": engine.max_len,
        "block_size": engine.block_size,
        "prefill_chunk": engine.prefill_chunk,
        "prefill_budget": engine.prefill_budget,
        "kv_dtype": engine.kv_dtype,
        "share_prefixes": engine.share_prefixes,
        "draft": getattr(args, "draft", None),
        "spec_k": engine.spec_k,
        "spec_adaptive": engine.spec_adaptive,
        "mesh": engine.mesh_shape,
        "temperature": engine.temperature,
        "top_k": engine.top_k,
        "sample_seed": engine.sample_seed,
        "rejected": len(rejections),
        "rejections": [{"uid": u, "reason": reason} for u, reason in rejections],
        "stats": engine.stats(),
        "requests": [
            {
                "uid": r.uid,
                "prompt_len": int(len(r.prompt)),
                "new_tokens": len(r.generated),
                "tokens": [int(t) for t in r.generated],
                "latency_s": r.latency_s,
                "ttft_s": r.ttft_s,
            }
            for _, r in sorted(engine.completed.items())
        ],
        **({} if ranks is None else {"mesh_backend": engine.mesh.backend,
                                     "mesh_ranks": ranks}),
    }


#: reference options the port refuses, with the ROADMAP item porting them
_UNPORTED = {
    "record": (False, "--record (perf ledger): ROADMAP item 1.15"),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-124m",
                    choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="smoke-sized config (--no-smoke for the real one)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--scheduler", choices=list(SCHEDULERS),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prompt-lo", type=int, default=4,
                    help="minimum sampled prompt length")
    ap.add_argument("--prompt-hi", type=int, default=16,
                    help="maximum sampled prompt length (inclusive)")
    ap.add_argument("--prefill-chunk", type=int, default=1)
    ap.add_argument("--prefill-budget", type=int, default=None)
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8"],
                    default="f32")
    ap.add_argument("--share-prefixes", action="store_true")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="sample all prompts with a common prefix of this "
                         "length (0 = fully random prompts)")
    ap.add_argument("--draft", default=None)
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--spec-adaptive", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DxM")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run one throwaway step before serving so TTFT "
                         "measures scheduling, not set-up")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the serve report JSON here")
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args(argv)
    for name, (default, why) in _UNPORTED.items():
        if getattr(args, name) != default:
            ap.error(f"not ported yet: {why}")
    if args.spec_k > 0 and not args.draft:
        ap.error("--spec-k requires --draft <arch>")
    if args.mesh is not None:
        try:
            mesh_mod.parse_mesh(args.mesh)
        except mesh_mod.MeshShapeError as e:
            ap.error(str(e))
    return args


def make_engine(args: argparse.Namespace, mesh=None,
                params=None) -> ServeEngine:
    """The engine the arguments ask for, with the port's seeded init, or
    the full ``params`` given; this rank's shards of them under
    ``mesh``."""
    def config(arch):
        return (configs.get_smoke_config(arch) if args.smoke
                else configs.get_config(arch))

    cfg = config(args.arch)
    if params is None:
        params = transformer.init_lm(cfg, seed=args.seed,
                                     device=args.device, mesh=mesh)
    elif mesh is not None:
        params = transformer.shard_params(params, mesh, mesh.device)
    draft_cfg = draft_params = None
    if args.spec_k > 0:
        # the target's seed: --draft of the served arch is
        # self-speculation (acceptance 1.0 at temperature 0)
        draft_cfg = config(args.draft)
        draft_params = transformer.init_lm(draft_cfg, seed=args.seed,
                                           device=args.device, mesh=mesh)
    device = args.device if mesh is None else mesh.device
    return ServeEngine(cfg, params, max_batch=args.max_batch,
                       max_len=args.max_len, scheduler=args.scheduler,
                       block_size=args.block_size,
                       prefill_chunk=args.prefill_chunk,
                       prefill_budget=args.prefill_budget,
                       kv_dtype=args.kv_dtype,
                       share_prefixes=args.share_prefixes,
                       temperature=args.temperature, top_k=args.top_k,
                       sample_seed=args.sample_seed, spec_k=args.spec_k,
                       draft_cfg=draft_cfg, draft_params=draft_params,
                       spec_adaptive=args.spec_adaptive, mesh=mesh,
                       device=device)


def serve(args: argparse.Namespace, engine: ServeEngine) -> dict:
    """Submit the sampled requests, drain the engine, print the summary,
    and return (and with ``--out`` write) the serve report.  Under a mesh
    every rank calls it: the ranks' rows are gathered to every rank, and
    only rank 0 prints and writes."""
    import torch.distributed as dist

    cfg = engine.cfg
    before = _counters(engine)
    rng = np.random.default_rng(args.seed)
    shared_prefix = (
        rng.integers(0, cfg.vocab,
                     size=args.shared_prefix_len).astype(np.int32)
        if args.shared_prefix_len > 0 else None)
    rejections: list = []
    for uid in range(args.requests):
        plen = int(rng.integers(args.prompt_lo, args.prompt_hi + 1))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        if shared_prefix is not None:
            prompt = np.concatenate([shared_prefix, prompt])
        try:
            engine.submit(Request(
                uid=uid,
                prompt=prompt,
                max_new_tokens=args.max_new,
            ))
        except RequestTooLong as e:
            # an oversized submission is a counted rejection, not a crash:
            # the remaining requests still get served and reported
            rejections.append((uid, str(e)))
    t0 = time.time()
    done = engine.run_until_drained()
    stats = engine.stats()
    ranks = None
    if engine.mesh is not None:
        ranks = [None] * engine.mesh.size
        dist.all_gather_object(ranks, _rank_row(engine, before,
                                                time.time() - t0))
        if engine.mesh.rank != 0:
            return build_report(args, engine, rejections, ranks)
    print(f"[{args.scheduler}] served {stats['requests']} requests, "
          f"{stats['new_tokens']} tokens, {stats['fused_steps']} fused steps "
          f"in {stats['wall_s']:.2f}s ({stats['tok_s']:.1f} tok/s)")
    print(f"  slot utilization {stats['slot_utilization']:.3f} "
          f"({stats['busy_slot_steps']}/{stats['slot_steps']} slot-steps), "
          f"latency p50 {stats['p50_latency_s']:.3f}s "
          f"p95 {stats['p95_latency_s']:.3f}s, "
          f"ttft p50 {stats['ttft_p50_s']:.3f}s "
          f"p95 {stats['ttft_p95_s']:.3f}s"
          + (f" [prefill chunk {engine.prefill_chunk}"
             + (f", budget {engine.prefill_budget}"
                if engine.prefill_budget else "") + "]"
             if engine.prefill_chunk > 1 else ""))
    if engine.kv_dtype != "f32" or engine.share_prefixes:
        print(f"  kv_dtype {stats['kv_dtype']}, "
              f"prefix sharing {'on' if stats['share_prefixes'] else 'off'}: "
              f"{stats['logical_blocks']} logical / "
              f"{stats['physical_blocks']} physical blocks "
              f"({stats['shared_block_hits']} shared hits, "
              f"{stats['cow_copies']} COW copies, "
              f"dedup {stats['block_dedup_ratio']:.3f})")
    if ranks is not None:
        steps = max(stats["fused_steps"], 1)
        print(f"  mesh {engine.mesh_shape} over {engine.mesh.backend}, "
              f"device lane utilization "
              f"{stats['device_lane_utilization']:.3f}:")
        for row in ranks:
            print(f"    rank {row['rank']} {tuple(row['coords'])} on "
                  f"{row['device']}: {row['local_kv_heads']} KV heads, "
                  f"{row['flash_decode_paged_sharded']} head-sharded decode "
                  f"launches, {row['calls']} collectives "
                  f"({row['calls'] / steps:.1f} a step), {row['bytes']} B "
                  f"sent, {row['host_bytes']} B staged through the host, "
                  f"{row['wall_s']:.2f}s, {row['tok_s']:.1f} tok/s")
    if engine.spec_k > 0:
        print(f"  speculative: draft {args.draft} k={engine.spec_k}"
              + (" (adaptive width)" if engine.spec_adaptive else "") + ", "
              f"acceptance {stats['acceptance_rate']:.3f} "
              f"({stats['accepted_tokens']}/{stats['drafted_tokens']} "
              f"drafts accepted, {stats['draft_steps']} draft steps, "
              f"{stats['target_steps']} target steps)")
    if rejections:
        print(f"  rejected {len(rejections)} oversized request(s) at submit:")
        for uid, reason in rejections:
            print(f"    req {uid}: {reason}")
    for uid in sorted(done):
        r = done[uid]
        lat = f"{r.latency_s:.3f}s" if r.latency_s is not None else "n/a"
        print(f"  req {uid}: prompt[{len(r.prompt)}] latency {lat} "
              f"-> {r.generated}")

    report = build_report(args, engine, rejections, ranks)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"serve report -> {args.out}")
    return report


def _serve_rank(mesh, args: argparse.Namespace, params=None) -> dict:
    engine = make_engine(args, mesh, params)
    if args.warmup:
        engine.warmup()
    return serve(args, engine)


def serve_on_mesh(args: argparse.Namespace, params=None,
                  timeout: float = 600.0) -> dict:
    """Serve on a ``--mesh DxM`` of spawned ranks; returns rank 0's
    report.  ``params``, full parameters as :func:`make_engine` builds
    them, reach the ranks shared (through CUDA IPC on the card), and each
    rank cuts its shards from them instead of drawing the seeded init."""
    return mesh_mod.spawn(_serve_rank, *mesh_mod.parse_mesh(args.mesh),
                          args, params, device=args.device, timeout=timeout)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh is not None:
        serve_on_mesh(args)
        return 0
    engine = make_engine(args)
    if args.warmup:
        engine.warmup()
    serve(args, engine)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
