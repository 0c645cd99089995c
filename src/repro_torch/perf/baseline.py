"""Baseline resolution policies for the regression gate (a port of
:mod:`repro.perf.baseline`).

A gate is only as good as what it compares against.  Three policies:

* ``latest`` — the most recent run in the series (the CI cold/warm pair).
* ``pinned:<prefix>`` — an explicit anchor: a run-id prefix or a git SHA
  prefix.  This is how a known-good release becomes the yardstick.
* ``median:<K>`` — a synthetic run whose numeric metrics are the
  per-metric median of the last K runs.  Medians absorb the wall-clock
  noise a single baseline run would bake in (the paper's measured
  quantities are best-of-repeats for the same reason); non-numeric
  metrics (configs, pass/fail) take the most recent run's value.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.perf.ledger import BenchRun, Ledger


def _median_run(runs: List[BenchRun]) -> BenchRun:
    """Synthetic rolling-median BenchRun over ``runs`` (newest last)."""
    newest = runs[-1]
    metrics: Dict[str, Dict[str, Any]] = {}
    for key in newest.metrics:
        merged: Dict[str, Any] = {}
        for name, value in newest.metrics[key].items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                merged[name] = value
                continue
            window = [
                r.metrics[key][name]
                for r in runs
                if key in r.metrics and name in r.metrics[key]
                and isinstance(r.metrics[key][name], (int, float))
                and not isinstance(r.metrics[key][name], bool)
            ]
            merged[name] = statistics.median(window) if window else value
        metrics[key] = merged
    return dataclasses.replace(
        newest,
        run_id=f"median-{len(runs)}-of:{newest.run_id}",
        metrics=metrics,
        meta={**newest.meta, "synthetic": f"median:{len(runs)}"},
    )


def validate_policy(policy: str) -> str:
    """Parse-check a policy string without touching a ledger; returns it.

    Raises ValueError on malformed input — callers that run expensive work
    before gating validate up front, and the CLIs use
    this as an argparse ``type`` so a typo exits 2 immediately.
    """
    if policy == "latest":
        return policy
    if policy.startswith("pinned:"):
        if not policy[len("pinned:"):]:
            raise ValueError("pinned: policy needs a run-id or git-SHA prefix")
        return policy
    if policy.startswith("median:"):
        try:
            k = int(policy[len("median:"):])
        except ValueError:
            raise ValueError(f"median: policy needs an integer K, got {policy!r}")
        if k < 1:
            raise ValueError(f"median:{k} — K must be >= 1")
        return policy
    raise ValueError(
        f"unknown baseline policy {policy!r}; "
        "expected latest | pinned:<prefix> | median:<K>"
    )


def resolve_baseline(
    ledger: Ledger,
    policy: str = "latest",
    *,
    series: Optional[str] = None,
    exclude: Iterable[str] = (),
) -> Optional[BenchRun]:
    """Resolve ``policy`` against the ledger; None when no run qualifies.

    ``exclude`` drops run ids from consideration — the gate passes the
    run under test here so a freshly recorded run never becomes its own
    baseline.  ``series`` restricts to one (chip, dtype) trajectory.

    ``latest`` and ``median:<K>`` consider only *healthy* runs (no
    ``meta["failed"]`` count): an aborted benchmark records a truncated
    wall time, and anchoring on it would fail the next healthy run
    spuriously.  ``pinned:`` is the operator's explicit choice and is
    never filtered.
    """
    validate_policy(policy)
    excluded = set(exclude)
    runs = [r for r in ledger.runs(series) if r.run_id not in excluded]
    if not runs:
        return None
    healthy = [r for r in runs if not r.meta.get("failed")]
    if policy == "latest":
        return healthy[-1] if healthy else None
    if policy.startswith("pinned:"):
        anchor = policy[len("pinned:"):]
        matches = [
            r for r in runs
            if r.run_id.startswith(anchor) or r.env.git_sha.startswith(anchor)
        ]
        return matches[-1] if matches else None
    k = int(policy[len("median:"):])
    return _median_run(healthy[-k:]) if healthy else None
