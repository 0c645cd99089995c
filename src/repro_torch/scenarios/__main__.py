"""CLI of the port's scenario-matrix traffic harness.

    python -m repro_torch.scenarios list  [--matrix smoke|full|spec.json]
                                          [--only GLOB]
    python -m repro_torch.scenarios run   [--matrix ...] [--only GLOB]
                                          [--jobs N] [--device cuda|cpu]
                                          [--out report.json]
                                          [--report-md matrix.md] [--no-twin]
                                          [--record]
    python -m repro_torch.scenarios gate  [--matrix ...] [--only GLOB]
                                          [--jobs N] [--device cuda|cpu]
                                          [--out ...] [--report-md ...]

The reference CLI's commands, options and exit codes
(``repro/scenarios/__main__.py``), on ``--device cuda`` (the default) or
``cpu``.  ``list`` expands the matrix and prints one cell id per line
(what ``--only`` globs against).  ``run`` executes every selected cell —
faulted cells also run their fault-free golden twin and diff the served
token streams — and checks per-cell SLOs; it exits non-zero only on cell
*errors*.  ``gate`` also fails on any golden-twin divergence or SLO
violation.  A glob that matches no cell exits 2.  ``--record`` appends one
perf-ledger run per cell that did not error (``python -m repro_torch.perf
list`` shows them, keyed ``scenario/<cell_id>``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.scenarios.matrix import MATRICES, load_matrix
from repro_torch.scenarios.runner import format_matrix_markdown, run_matrix


def _add_select(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--matrix", default="smoke",
                    help=f"named matrix ({'/'.join(sorted(MATRICES))}) or a "
                         "JSON MatrixSpec file")
    ap.add_argument("--only", default=None,
                    help="fnmatch glob over cell ids (e.g. '*device-loss')")


def _add_run(ap: argparse.ArgumentParser) -> None:
    _add_select(ap)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run concurrently (threads, one engine a "
                         "cell)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--record", action="store_true",
                    help="append one perf-ledger BenchRun per cell "
                         "(repro_torch.perf)")
    ap.add_argument("--no-twin", action="store_true",
                    help="skip golden-twin execution/diffing (faster, "
                         "forfeits the equivalence check)")
    ap.add_argument("--out", default=None,
                    help="write the full matrix report JSON here")
    ap.add_argument("--report-md", default=None,
                    help="write the markdown matrix table here")


def _print_summary(results) -> None:
    for r in results:
        if r.error:
            line = f"ERROR {r.error}"
        else:
            bits = [f"{r.stats.get('tok_s', 0.0):.1f} tok/s",
                    f"util {r.stats.get('slot_utilization', 0.0):.3f}"]
            if r.golden_checked:
                bits.append("twin=" + ("ok" if r.golden_ok else "DIFF"))
            if r.slo_failures:
                bits.append("SLO: " + "; ".join(r.slo_failures))
            line = ", ".join(bits)
        mark = "ok " if r.ok else "FAIL"
        print(f"  [{mark}] {r.cell.cell_id}: {line}")
    print(f"{sum(r.ok for r in results)}/{len(results)} cells ok")


def _run(args: argparse.Namespace, *, strict: bool) -> int:
    spec = load_matrix(args.matrix)
    results = run_matrix(spec, only=args.only, jobs=args.jobs,
                         check_twin=not args.no_twin, record=args.record,
                         device=args.device)
    if not results:
        print(f"error: no cells match --only {args.only!r}", file=sys.stderr)
        return 2
    _print_summary(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kind": "scenario_matrix",
                       "matrix": args.matrix,
                       "cells": [r.report() for r in results]}, f, indent=1)
        print(f"matrix report -> {args.out}")
    if args.report_md:
        with open(args.report_md, "w") as f:
            f.write(format_matrix_markdown(results))
        print(f"matrix markdown -> {args.report_md}")
    if strict:
        bad = [r for r in results if not r.ok]
        if bad:
            print(f"scenario gate: {len(bad)} failing cell(s)",
                  file=sys.stderr)
            return 1
        print("scenario gate: all cells ok")
        return 0
    return 1 if any(r.error for r in results) else 0


def cmd_list(args: argparse.Namespace) -> int:
    import fnmatch

    spec = load_matrix(args.matrix)
    cells = spec.cells()
    if args.only:
        cells = [c for c in cells if fnmatch.fnmatch(c.cell_id, args.only)]
    for c in cells:
        print(c.cell_id)
    print(f"{len(cells)} cells", file=sys.stderr)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenarios")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_select(sub.add_parser("list", help="print matching cell ids"))
    _add_run(sub.add_parser("run", help="run the matrix"))
    _add_run(sub.add_parser(
        "gate", help="run the matrix; fail on twin/SLO/error"))
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return cmd_list(args)
    return _run(args, strict=args.cmd == "gate")


if __name__ == "__main__":
    raise SystemExit(main())
