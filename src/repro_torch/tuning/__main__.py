"""CLI for the roofline-guided autotuner (a port of ``python -m
repro_torch.tuning``).

    python -m repro_torch.tuning                    # every tunable kernel
    python -m repro_torch.tuning --kernels gemm jacobi2d  # a subset
    python -m repro_torch.tuning --dtypes space     # sweep each ELEN axis
    python -m repro_torch.tuning --cap 2 --keep 2 --jobs 4 --out tuning.json
    python -m repro_torch.tuning --device cpu --mode interpret --cap 2

Times the CUDA kernels on the card by default (``--device cuda``, ``--mode
compiled``, ``--chip h100``); ``--device cpu --mode interpret`` times the
plain versions.  Emits a table on stderr and a machine-readable
``tuning.json`` report (``--out``; default stdout), whose
``stats.timing_runs`` counts the candidates timed.  Records persist in the
tuning store (``$REPRO_ARTIFACT_DIR/torch/tuning``), so a second invocation
reports ``cached: true`` per record and performs zero timing runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

from repro_torch.core import hw


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning",
        description="Roofline-guided kernel autotuner; emits tuning.json.",
    )
    ap.add_argument("--kernels", nargs="+", default=None,
                    help="kernel names (default: every tunable kernel)")
    ap.add_argument("--chip", default="h100", choices=sorted(hw.CHIPS),
                    help="chip model the roofline prunes against")
    ap.add_argument("--dtypes", nargs="+", default=None,
                    help="ELEN axis: explicit dtypes, or 'space' to sweep "
                         "each kernel space's own candidates")
    ap.add_argument("--mode", default="compiled",
                    choices=["interpret", "compiled"],
                    help="timing mode for survivors: the CUDA kernels "
                         "(compiled) or the plain versions (interpret)")
    ap.add_argument("--device", default="cuda",
                    help="where the survivors run and are timed")
    ap.add_argument("--keep", type=int, default=4,
                    help="survivors timed after roofline pruning")
    ap.add_argument("--cap", type=int, default=None,
                    help="take only the first N values per axis (tiny spaces)")
    ap.add_argument("--repeats", type=int, default=2,
                    help="timing repeats per survivor (best-of)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="thread-pool width over (kernel, dtype) cells")
    ap.add_argument("--force", action="store_true",
                    help="re-tune even on a store hit")
    ap.add_argument("--store-dir", default=None,
                    help="tuning store directory (default: "
                         "$REPRO_ARTIFACT_DIR/torch/tuning)")
    ap.add_argument("--no-store", action="store_true",
                    help="never read/write the persistent store")
    ap.add_argument("--out", default=None,
                    help="write tuning.json here (default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list tunable kernels and exit")
    ap.add_argument("--records", action="store_true",
                    help="list persisted tuning records and exit")
    args = ap.parse_args(argv)

    if args.records:
        # enumerate through the store's listing surface (iter_json) rather
        # than globbing its files — same path the perf gate's staleness
        # check walks
        from repro_torch.tuning.records import TUNING_VERSION, resolve_store

        store = resolve_store(args.store_dir or "default")
        n = 0
        for fp, payload in store.iter_json():
            if payload.get("tuning_version") != TUNING_VERSION:
                continue
            r = payload.get("record") or {}
            cfg = " ".join(f"{k}={v}" for k, v in sorted((r.get("config") or {}).items()))
            print(f"{fp}  {r.get('kernel')}@{r.get('chip')}/{r.get('dtype')}  "
                  f"[{cfg}]  best={r.get('best_time_s', 0):.3g}s")
            n += 1
        print(f"[{n} persisted records in {store.cache_dir}]", file=sys.stderr)
        return 0

    from repro_torch.tuning import (
        format_records,
        report_dict,
        tunable_kernels,
        tune_kernels,
    )

    if args.list:
        for name in tunable_kernels():
            print(name)
        return 0

    known = set(tunable_kernels())
    names = args.kernels or sorted(known)
    unknown = [n for n in names if n not in known]
    if unknown:
        print(f"error: not tunable {unknown}; see --list", file=sys.stderr)
        return 2

    store = None if args.no_store else (args.store_dir or "default")
    t0 = time.perf_counter()
    records = tune_kernels(
        names,
        chip=hw.get_chip(args.chip),
        dtypes=args.dtypes,
        jobs=args.jobs,
        cap=args.cap,
        store=store,
        mode=args.mode,
        keep=args.keep,
        repeats=args.repeats,
        force=args.force,
        device=args.device,
    )
    wall = time.perf_counter() - t0

    print(format_records(records), file=sys.stderr)
    cached = sum(1 for r in records if r.cached)
    print(
        f"[{len(records)} records ({cached} cached) in {wall:.2f}s]",
        file=sys.stderr,
    )
    payload = json.dumps(report_dict(records, wall_s=wall), indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"tuning report -> {args.out}", file=sys.stderr)
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
