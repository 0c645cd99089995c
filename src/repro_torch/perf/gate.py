"""The regression gate + trajectory reporting (a port of
:mod:`repro.perf.gate`).

``gate_run`` is the enforcement point: resolve a baseline (policy), run the
noise-aware comparison, triage every confirmed regression through the
Fig. 8 decision tree, and fold it all into a :class:`GateResult` whose
``exit_code`` CI can act on.  ``format_markdown`` renders the trajectory
and the latest gate for humans; ``export_trajectory`` writes one
machine-readable ``BENCH_<seq>.json`` per run — the stable interchange
format downstream dashboards consume.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.perf.baseline import resolve_baseline
from repro_torch.perf.compare import RunComparison, compare_runs
from repro_torch.perf.ledger import PERF_VERSION, BenchRun, Ledger, default_ledger
from repro_torch.perf.triage import Triage, triage_regressions


@dataclasses.dataclass
class GateResult:
    """Outcome of gating one run against one resolved baseline."""

    ok: bool
    run_id: str
    baseline_id: Optional[str]
    policy: str
    comparison: Optional[RunComparison]
    triages: List[Triage]
    note: str = ""

    @property
    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "perf_gate",
            "ok": self.ok,
            "exit_code": self.exit_code,
            "run_id": self.run_id,
            "baseline_id": self.baseline_id,
            "policy": self.policy,
            "note": self.note,
            "comparison": None if self.comparison is None else self.comparison.to_dict(),
            "triage": [t.to_dict() for t in self.triages],
        }

    def describe(self) -> str:
        if self.comparison is None:
            status = "PASS" if self.ok else "FAIL"
            return f"gate {status} ({self.note or 'no baseline'})"
        if self.ok:
            out = (
                f"gate PASS: {len(self.comparison.deltas)} metrics vs "
                f"baseline {self.baseline_id[:12]} ({self.policy}), "
                f"{len(self.comparison.improvements)} improved"
            )
            return out + (f"\n  NOTE: {self.note}" if self.note else "")
        lines = [
            f"gate FAIL: {len(self.comparison.regressions)} regression(s) vs "
            f"baseline {self.baseline_id[:12]} ({self.policy})"
        ]
        for t in self.triages:
            lines.append(f"  - {t.narrative}")
        return "\n".join(lines)


def gate_run(
    run: BenchRun,
    ledger: Optional[Ledger] = None,
    *,
    policy: str = "latest",
    wall_tol_scale: float = 1.0,
    tuning_store: Any = "default",
) -> GateResult:
    """Gate ``run`` against the baseline ``policy`` resolves to.

    The run under test is always excluded from baseline resolution (a
    freshly recorded run must not gate against itself), and resolution is
    restricted to the run's own (chip, dtype) series.  A series with no
    prior run passes trivially — the first point of a trajectory has
    nothing to regress from.
    """
    ledger = ledger or default_ledger()
    baseline = resolve_baseline(
        ledger, policy, series=run.env.series_key(), exclude=(run.run_id,)
    )
    note = ""
    if (baseline is not None and policy == "latest"
            and not set(baseline.metrics) & set(run.metrics)):
        # the shared ledger holds heterogeneous records (benchmark runs,
        # service reports): "latest" means the latest COMPARABLE run, or a
        # disjoint record would silently turn the gate vacuous
        for cand in reversed(ledger.runs(run.env.series_key())):
            if (cand.run_id != run.run_id and not cand.meta.get("failed")
                    and set(cand.metrics) & set(run.metrics)):
                note = (f"latest run {baseline.run_id[:12]} shares no metrics; "
                        f"fell back to {cand.run_id[:12]} (seq {cand.seq})")
                baseline = cand
                break
    if baseline is None:
        # the first point of a trajectory has nothing to regress from —
        # but an EXPLICIT pin that fails to resolve is an operator error,
        # not a trivial pass: a typo'd SHA must never go permanently green
        pinned_miss = policy.startswith("pinned:")
        return GateResult(
            ok=not pinned_miss,
            run_id=run.run_id,
            baseline_id=None,
            policy=policy,
            comparison=None,
            triages=[],
            note=(f"pinned baseline {policy!r} did not resolve to any run"
                  if pinned_miss else
                  f"no baseline for series {run.env.series_key()!r} "
                  f"under policy {policy!r}"),
        )
    comparison = compare_runs(baseline, run, wall_tol_scale=wall_tol_scale)
    if comparison.missing_metrics:
        # a gated metric that stops being reported is lost coverage, not a
        # pass — it doesn't flip the verdict, but it must be said out loud
        note = (note + "; " if note else "") + (
            "metrics vanished vs baseline: "
            + ", ".join(comparison.missing_metrics[:5])
            + ("..." if len(comparison.missing_metrics) > 5 else "")
        )
    if not comparison.deltas:
        # still passes (disjoint subsets are an operator choice), but a
        # vacuous gate must say so out loud, never look like coverage
        note = (note + "; " if note else "") + (
            "VACUOUS: baseline shares no metrics with this run — "
            "nothing was actually gated"
        )
    triages = triage_regressions(
        comparison, baseline, run, tuning_store=tuning_store
    )
    return GateResult(
        ok=comparison.ok,
        run_id=run.run_id,
        baseline_id=baseline.run_id,
        policy=policy,
        comparison=comparison,
        triages=triages,
        note=note,
    )


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


def _headline_wall(run: BenchRun) -> float:
    return sum(
        m["wall_s"] for m in run.metrics.values()
        if isinstance(m.get("wall_s"), (int, float))
    )


def format_markdown(
    ledger: Ledger,
    *,
    series: Optional[str] = None,
    gate: Optional[GateResult] = None,
) -> str:
    """Human-readable trajectory report (optionally with the latest gate)."""
    lines = ["# Performance trajectory", ""]
    all_series = [series] if series else (ledger.series() or [])
    if not all_series:
        lines.append("_(empty ledger)_")
    for s in all_series:
        runs = ledger.runs(s)
        if not runs:
            continue
        lines.append(f"## series `{s}` — {len(runs)} run(s)")
        lines.append("")
        lines.append("| seq | run | git | tuned | workloads | wall (s) |")
        lines.append("|---:|---|---|---|---:|---:|")
        for r in runs:
            lines.append(
                f"| {r.seq} | `{r.run_id[:12]}` | `{r.env.git_sha}` | "
                f"`{r.env.tuned_hash or '-'}` | {len(r.metrics)} | "
                f"{_headline_wall(r):.3f} |"
            )
        lines.append("")
    if gate is not None:
        lines.append("## gate")
        lines.append("")
        lines.append(f"**{'PASS' if gate.ok else 'FAIL'}** — run "
                     f"`{gate.run_id[:12]}` vs baseline "
                     f"`{(gate.baseline_id or 'none')[:12]}` "
                     f"(policy `{gate.policy}`)")
        if gate.note:
            lines.append(f"- {gate.note}")
        if gate.comparison is not None:
            for reg in gate.comparison.regressions:
                lines.append(f"- REGRESSION: {reg.describe()}")
            for imp in gate.comparison.improvements:
                lines.append(
                    f"- improved: {imp.key}: {imp.metric} {imp.before} -> "
                    f"{imp.after} ({imp.rel_delta:+.1%})"
                )
        for t in gate.triages:
            lines.append(f"- triage: {t.narrative}")
        lines.append("")
    return "\n".join(lines)


def export_trajectory(
    ledger: Ledger,
    out_dir: str,
    *,
    series: Optional[str] = None,
) -> List[str]:
    """Write one ``BENCH_<seq>.json`` per run; returns the paths written.

    Each file is a self-contained trajectory point (``perf_version`` +
    the full BenchRun dict), so downstream consumers never need the
    ledger directory itself.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    seen_seqs: set = set()
    for run in ledger.runs(series):
        # concurrent recorders may race to one seq (both entries survive in
        # the ledger); a duplicate seq gets the run id in its filename so
        # the export never silently drops a trajectory point
        name = (f"BENCH_{run.seq}.json" if run.seq not in seen_seqs
                else f"BENCH_{run.seq}_{run.run_id[:8]}.json")
        seen_seqs.add(run.seq)
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump(
                {"kind": "perf_trajectory_point",
                 "perf_version": PERF_VERSION,
                 "run": run.to_dict()},
                f,
                indent=1,
            )
        paths.append(path)
    return paths
