"""CLI for the perf trajectory ledger + regression gate (the reference's
``python -m repro.perf``, its commands, flags and exit codes).

    REPRO_ARTIFACT_DIR=/tmp/a python -m repro_torch.launch.serve --record
    python -m repro_torch.perf record --serving serve.json --chip h100
    python -m repro_torch.perf compare --baseline latest
    python -m repro_torch.perf gate --baseline pinned:abc123 --tol-wall 2.0
    python -m repro_torch.perf report --out /tmp/perf-report
    python -m repro_torch.perf list

``record`` appends one BenchRun from any mix of ``summary.json`` /
``tuning.json`` / analysis-service reports / ``launch.serve`` serve
reports.  ``gate`` exits 1 on confirmed regressions and prints each one's
decision-tree triage (2 when the ledger is empty, the run is unknown or
the policy is malformed).  ``report`` emits the markdown trajectory plus
one machine-readable ``BENCH_<seq>.json`` per run into ``--out``.  The
ledger lives in ``$REPRO_ARTIFACT_DIR/torch/perf`` unless ``--store-dir``
overrides it; ``--store-dir`` reads either package's ledger.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.perf.baseline import resolve_baseline, validate_policy
from repro_torch.perf.compare import compare_runs
from repro_torch.perf.gate import export_trajectory, format_markdown, gate_run
from repro_torch.perf.ledger import Ledger, capture_env


def _ledger(args: argparse.Namespace) -> Ledger:
    return Ledger(args.store_dir)


def _resolve_run(ledger: Ledger, ref: Optional[str], series: Optional[str]):
    if ref:
        run = ledger.get(ref)
        if run is None:
            print(f"error: no unique run matching {ref!r}", file=sys.stderr)
            return None
        return run
    run = ledger.latest(series)
    if run is None:
        print("error: ledger is empty; record a run first", file=sys.stderr)
    return run


def cmd_record(args: argparse.Namespace) -> int:
    def load(path: Optional[str]):
        if path is None:
            return None
        with open(path) as f:
            return json.load(f)

    summary = load(args.summary)
    tuning = load(args.tuning)
    analyses = load(args.analysis)
    serving = load(args.serving)
    if summary is None and tuning is None and analyses is None and serving is None:
        print("error: pass at least one of "
              "--summary/--tuning/--analysis/--serving", file=sys.stderr)
        return 2
    # a summary stamped by benchmarks.run carries its own RunEnv — honor it
    # (record never re-derives environment); capture only when absent
    env = None
    if summary is None or not summary.get("env"):
        env = capture_env(chip=args.chip, dtype=args.dtype)
    ledger = _ledger(args)
    run = ledger.record_sources(
        summary=summary, tuning=tuning, analyses=analyses, serving=serving,
        env=env, meta={"note": args.note} if args.note else None,
    )
    print(f"recorded run {run.run_id} (seq {run.seq}, series "
          f"{run.env.series_key()}, {len(run.metrics)} workloads) "
          f"-> {ledger.root}")
    return 0


def cmd_compare(args: argparse.Namespace) -> int:
    ledger = _ledger(args)
    run = _resolve_run(ledger, args.run, args.series)
    if run is None:
        return 2
    baseline = resolve_baseline(
        ledger, args.baseline, series=run.env.series_key(),
        exclude=(run.run_id,),
    )
    if baseline is None:
        print(f"no baseline under policy {args.baseline!r}", file=sys.stderr)
        return 2
    cmp_ = compare_runs(baseline, run, wall_tol_scale=args.tol_wall)
    for d in cmp_.deltas:
        flag = "REG" if d.regressed else ("imp" if d.improved else "   ")
        print(f"{flag}  {d.key:44s} {d.metric:24s} "
              f"{d.before!s:>14s} -> {d.after!s:<14s} {d.rel_delta:+.1%}")
    print(f"\n[{len(cmp_.deltas)} deltas, {len(cmp_.regressions)} regressions, "
          f"{len(cmp_.improvements)} improvements vs {baseline.run_id[:12]}]")
    return 0


def cmd_gate(args: argparse.Namespace) -> int:
    ledger = _ledger(args)
    run = _resolve_run(ledger, args.run, args.series)
    if run is None:
        return 2
    result = gate_run(
        run, ledger, policy=args.baseline, wall_tol_scale=args.tol_wall,
        tuning_store=None if args.no_tuning_store else "default",
    )
    print(result.describe())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result.to_dict(), f, indent=1)
        print(f"gate result -> {args.out}", file=sys.stderr)
    return result.exit_code


def cmd_report(args: argparse.Namespace) -> int:
    ledger = _ledger(args)
    gate = None
    if args.gate:
        run = ledger.latest(args.series)
        if run is not None:
            gate = gate_run(run, ledger, policy=args.baseline,
                            wall_tol_scale=args.tol_wall)
    md = format_markdown(ledger, series=args.series, gate=gate)
    if args.out:
        import os

        os.makedirs(args.out, exist_ok=True)
        md_path = os.path.join(args.out, "report.md")
        with open(md_path, "w") as f:
            f.write(md)
        paths = export_trajectory(ledger, args.out, series=args.series)
        print(f"report -> {md_path} (+ {len(paths)} BENCH_<seq>.json)")
    else:
        print(md)
    return 0


def cmd_list(args: argparse.Namespace) -> int:
    ledger = _ledger(args)
    runs = ledger.runs(args.series)
    if not runs:
        print("(empty ledger)")
        return 0
    for r in runs:
        print(f"{r.seq:4d}  {r.run_id}  {r.env.series_key():20s} "
              f"git={r.env.git_sha}  workloads={len(r.metrics)}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf",
        description="Perf trajectory ledger + decision-tree regression gate.",
    )
    ap.add_argument("--store-dir", default=None,
                    help="ledger directory (default: "
                         "$REPRO_ARTIFACT_DIR/torch/perf)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("record", help="append a BenchRun from artifacts")
    p.add_argument("--summary", default=None, help="benchmarks summary.json")
    p.add_argument("--tuning", default=None, help="autotuner tuning.json")
    p.add_argument("--analysis", default=None,
                   help="analysis service report JSON")
    p.add_argument("--serving", default=None,
                   help="launch.serve serve-report JSON")
    p.add_argument("--chip", default="grace-core")
    p.add_argument("--dtype", default="fp32")
    p.add_argument("--note", default=None, help="free-form run annotation")
    p.set_defaults(fn=cmd_record)

    for name, fn in (("compare", cmd_compare), ("gate", cmd_gate)):
        p = sub.add_parser(name, help=f"{name} a run against a baseline")
        p.add_argument("--run", default=None,
                       help="run id prefix (default: latest)")
        p.add_argument("--baseline", default="latest", type=validate_policy,
                       help="latest | pinned:<prefix> | median:<K>")
        p.add_argument("--series", default=None,
                       help="restrict to one chip/dtype series")
        p.add_argument("--tol-wall", type=float, default=1.0,
                       help="scale noisy (timing) tolerances")
        if name == "gate":
            p.add_argument("--out", default=None,
                           help="write the gate result JSON here")
            p.add_argument("--no-tuning-store", action="store_true",
                           help="skip the TuningRecord staleness check")
        p.set_defaults(fn=fn)

    p = sub.add_parser("report",
                       help="markdown trajectory + BENCH_<seq>.json export")
    p.add_argument("--out", default=None,
                   help="directory for report.md + BENCH_<seq>.json "
                        "(default: print markdown)")
    p.add_argument("--series", default=None)
    p.add_argument("--gate", action="store_true",
                   help="include a gate of the latest run")
    p.add_argument("--baseline", default="latest", type=validate_policy)
    p.add_argument("--tol-wall", type=float, default=1.0)
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("list", help="list recorded runs")
    p.add_argument("--series", default=None)
    p.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
