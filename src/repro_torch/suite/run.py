"""Benchmark driver: one benchmark per paper table/figure, the counterpart
of the reference's ``benchmarks/run.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.suite.run [--only fig3_vectorization]
    PYTHONPATH=src python -m repro_torch.suite.run --device cpu --out /tmp/suite
    PYTHONPATH=src python -m repro_torch.suite.run --tune [--tune-cap 2]
    PYTHONPATH=src python -m repro_torch.suite.run --record --gate [--baseline latest]
    PYTHONPATH=src python -m repro_torch.suite.run --list

Writes one CSV per benchmark, a machine-readable ``summary.json`` (per-
benchmark rows / wall time / pass-fail, stamped with the run environment:
git SHA, chip, torch and CUDA versions, the card's ``nvidia-smi`` line,
dtype, active tuned-config hash — the artifact the perf ledger ingests),
and prints each table.  The timed benchmarks run on ``--device`` (the
card unless ``--device cpu``); ``--chip`` (default: ``h100`` on the card,
``grace-core`` on the CPU) is the chip stamped into the environment.
``--jobs N`` runs benchmarks concurrently on a thread pool.  ``--tune``
runs the roofline-guided kernel autotuner first on ``--device`` (records
persist in the tuning store — a repeat run performs zero timing runs) and
writes its report to ``<out>/tuning.json``; ``--tune-cap N`` shrinks every
tuning axis to its first N values.  ``--record`` appends this run (summary
+ tuning report when present) to the perf ledger
(:mod:`repro_torch.perf`); ``--gate`` additionally compares it against
``--baseline`` (``latest`` | ``pinned:<sha>`` | ``median:<K>``) and exits
non-zero on confirmed regressions, printing each one's Fig.-8 triage.
``--list`` enumerates both the figure/table benchmarks and every workload
registered in the unified ``repro_torch.analysis`` registry.

Exit codes: 0 on success (and for ``--list``), 2 for an unknown ``--only``
or a malformed ``--baseline`` under ``--gate`` (before any benchmark
runs), 1 when a benchmark failed or the gate confirmed a regression.
"""

from __future__ import annotations

import argparse
import csv
import functools
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def _write_csv(path: str, rows) -> None:
    if not rows:
        return
    keys = list(rows[0].keys())
    for r in rows[1:]:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def _print_table(name: str, rows) -> None:
    print(f"\n== {name} " + "=" * max(0, 66 - len(name)))
    if not rows:
        print("(no rows)")
        return
    keys = list(rows[0].keys())
    widths = {k: max(len(str(k)), *(len(str(r.get(k, ""))) for r in rows)) for k in keys}
    print("  ".join(str(k).ljust(widths[k]) for k in keys))
    for r in rows:
        print("  ".join(str(r.get(k, "")).ljust(widths[k]) for k in keys))


def _list() -> int:
    from repro_torch.analysis import list_workloads
    from repro_torch.suite.figures import ALL

    print("benchmarks (python -m repro_torch.suite.run --only <name>):")
    for name in ALL:
        print(f"  {name}")
    print("\nworkloads (repro_torch.analysis.analyze(<name>)):")
    for name in list_workloads():
        print(f"  {name}")
    return 0


def _run_tuning(out_dir: str, *, jobs: int, cap=None, repeats: int = 2,
                device: str = "cuda") -> dict:
    """Roofline-guided sweep over every tunable kernel -> tuning.json.

    Runs before the benchmarks so tuned configs are active for them; store
    hits make repeat invocations timing-free.  On the CPU the plain
    versions are timed (``mode="interpret"``).  Returns the report dict so
    ``--record`` can ingest it into the perf ledger alongside the summary.
    """
    from repro_torch.tuning import format_records, report_dict, tune_kernels

    t0 = time.time()
    mode = "interpret" if device == "cpu" else "compiled"
    records = tune_kernels(jobs=jobs, cap=cap, repeats=repeats, mode=mode,
                           device=device)
    print("\n== tuning " + "=" * 60)
    print(format_records(records))
    report = report_dict(records, wall_s=time.time() - t0)
    path = os.path.join(out_dir, "tuning.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    cached = sum(1 for r in records if r.cached)
    print(f"[{len(records)} tuning records ({cached} cached) -> {path}]")
    return report


def _run_benchmark(name: str, fn) -> dict:
    """Execute one benchmark; never raises (summary rows record failures)."""
    t0 = time.time()
    try:
        rows = fn()
        return {"name": name, "ok": True, "rows": len(rows),
                "wall_s": round(time.time() - t0, 3), "error": None,
                "_rows": rows}
    except Exception as e:  # noqa: BLE001 — report all benchmark failures
        import traceback

        traceback.print_exc()
        return {"name": name, "ok": False, "rows": 0,
                "wall_s": round(time.time() - t0, 3), "error": repr(e),
                "_rows": []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.suite.run")
    ap.add_argument("--only", default=None, help="run a single benchmark")
    ap.add_argument("--list", action="store_true",
                    help="list benchmarks + registered workloads and exit")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run benchmarks concurrently on a thread pool")
    ap.add_argument("--tune", action="store_true",
                    help="run the kernel autotuner first; writes tuning.json")
    ap.add_argument("--tune-cap", type=int, default=None,
                    help="shrink tuning axes to their first N values")
    ap.add_argument("--tune-repeats", type=int, default=2,
                    help="timing repeats per tuning survivor (best-of)")
    ap.add_argument("--record", action="store_true",
                    help="append this run to the perf trajectory ledger")
    ap.add_argument("--gate", action="store_true",
                    help="gate this run against --baseline (implies --record); "
                         "exit non-zero on confirmed regressions")
    ap.add_argument("--baseline", default="latest",
                    help="gate baseline policy: latest | pinned:<prefix> | "
                         "median:<K>")
    ap.add_argument("--tol-wall", type=float, default=1.0,
                    help="scale the gate's noisy (wall-time) tolerances")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device the timed benchmarks (and --tune) run on")
    ap.add_argument("--chip", default=None,
                    help="chip name stamped into the run environment "
                         "(default: h100 on cuda, grace-core on cpu)")
    ap.add_argument("--dtype", default="fp32",
                    help="dtype stamped into the run environment")
    ap.add_argument("--out", default="experiments/bench")
    args = ap.parse_args(argv)

    if args.list:
        return _list()

    if args.gate:
        # fail a malformed policy BEFORE minutes of benchmarks run
        from repro_torch.perf.baseline import validate_policy

        try:
            validate_policy(args.baseline)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    from repro_torch.core.device import resolve_device
    from repro_torch.perf import device_chip
    from repro_torch.suite.figures import ALL, TIMED

    if args.only is not None and args.only not in ALL:
        print(f"error: unknown benchmark {args.only!r}; available: "
              f"{', '.join(ALL)}", file=sys.stderr)
        return 2

    resolve_device(args.device)  # raises where no card answers
    chip = args.chip or device_chip(args.device)
    os.makedirs(args.out, exist_ok=True)
    tuning_report = None
    if args.tune:
        tuning_report = _run_tuning(args.out, jobs=args.jobs, cap=args.tune_cap,
                                    repeats=args.tune_repeats,
                                    device=args.device)
    names = [args.only] if args.only else list(ALL)
    todo = {name: functools.partial(ALL[name], device=args.device)
            if name in TIMED else ALL[name] for name in names}
    t_total = time.time()
    if args.jobs > 1 and len(todo) > 1:
        with ThreadPoolExecutor(max_workers=args.jobs) as pool:
            results = list(pool.map(
                lambda item: _run_benchmark(*item), todo.items()
            ))
    else:
        results = [_run_benchmark(name, fn) for name, fn in todo.items()]

    failed = []
    for res in results:
        rows = res.pop("_rows")
        if not res["ok"]:
            failed.append((res["name"], res["error"]))
            continue
        _write_csv(os.path.join(args.out, f"{res['name']}.csv"), rows)
        _print_table(res["name"], rows)
        print(f"[{res['name']}: {res['rows']} rows in {res['wall_s']:.1f}s]")

    from repro_torch.perf import capture_env

    env = capture_env(chip=chip, dtype=args.dtype)
    summary = {
        "kind": "benchmarks_summary",
        "schema": 1,
        "benchmarks": results,  # per-benchmark rows, wall time, pass/fail
        "total_wall_s": round(time.time() - t_total, 3),
        "jobs": args.jobs,
        "passed": sum(1 for r in results if r["ok"]),
        "failed": len(failed),
        # git SHA / chip / torch and CUDA versions / the card / dtype /
        # tuned-config hash: the perf ledger ingests summaries without
        # re-deriving environment
        "env": env.to_dict(),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)

    gate_failed = False
    if args.record or args.gate:
        from repro_torch.perf import default_ledger, gate_run

        ledger = default_ledger()
        # a run with failed benchmarks is still a trajectory point (its
        # ok=False rows are the signal), but meta["failed"] marks it so
        # baseline resolution never anchors on an aborted run's wall times
        run = ledger.record_sources(
            summary=summary, tuning=tuning_report, env=env,
            meta={"out": args.out, "only": args.only, "failed": len(failed)},
        )
        print(f"\n[perf ledger: recorded run {run.run_id[:12]} "
              f"(seq {run.seq}) -> {ledger.root}]")
        if args.gate:
            result = gate_run(run, ledger, policy=args.baseline,
                              wall_tol_scale=args.tol_wall)
            print(result.describe())
            gate_failed = not result.ok

    if failed:
        print(f"\nFAILED: {failed}")
        return 1
    print(f"\nall {len(todo)} benchmarks written to {args.out}/ "
          f"(+ summary.json)")
    return 1 if gate_failed else 0


if __name__ == "__main__":
    sys.exit(main())
