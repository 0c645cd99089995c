"""Noise-aware per-metric comparison of two BenchRuns (a port of
:mod:`repro.perf.compare`, every tolerance unchanged).

Every metric the ledger tracks carries a :class:`MetricSpec`: which
direction is *worse*, how much relative movement is tolerated before a
delta becomes a :class:`Regression`, and whether the metric is noisy
(wall-clock times — tolerances scale with ``wall_tol_scale``) or
deterministic (the analytic counters: AI, R_ins, FLOPs, traffic — a
store round-trip reproduces them bit-for-bit, so their tolerances only
absorb float formatting, not measurement noise).

The output is typed all the way down: ``compare_runs`` returns a
:class:`RunComparison` holding every :class:`MetricDelta` plus the
:class:`Regression` subset the gate acts on; the triage layer
(:mod:`repro_torch.perf.triage`) then explains each regression with the
paper's own decision tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.perf.ledger import BenchRun


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """How one named metric is judged."""

    name: str
    worse: str  # "higher" | "lower" — the direction that regresses
    rel_tol: float  # relative movement tolerated in the worse direction
    noisy: bool = False  # wall-clock metrics: tolerance scales with the gate knob


#: The gate's metric contract.  Timing metrics are noisy; counter metrics
#: are deterministic (2% covers dtype-cast and model-revision jitter while
#: still catching any real shift); ``perf_class`` regresses on ANY drop —
#: a Fig. 8 class transition is the headline signal, not a percentage.
SPECS: Dict[str, MetricSpec] = {
    s.name: s
    for s in (
        MetricSpec("wall_s", "higher", 0.10, noisy=True),
        MetricSpec("best_time_s", "higher", 0.15, noisy=True),
        MetricSpec("default_time_s", "higher", 0.25, noisy=True),
        MetricSpec("speedup_vs_default", "lower", 0.25, noisy=True),
        MetricSpec("rows", "lower", 0.0),
        MetricSpec("ai", "lower", 0.02),
        MetricSpec("r_ins", "lower", 0.02),
        MetricSpec("flops", "higher", 0.02),
        MetricSpec("hbm_bytes", "higher", 0.02),
        MetricSpec("gather_bytes", "higher", 0.05),
        MetricSpec("vectorizable_fraction", "lower", 0.02),
        MetricSpec("predicted_speedup", "lower", 0.02),
        MetricSpec("perf_class", "lower", 0.0),
        # serving metrics (launch.serve reports): throughput / latency are
        # wall-clock noisy; the scheduler counters are deterministic given
        # the request trace, and slot utilization dropping means the
        # scheduler started idling lanes — the Eq. 1 signal for serving
        MetricSpec("tok_s", "lower", 0.15, noisy=True),
        MetricSpec("p50_latency_s", "higher", 0.15, noisy=True),
        MetricSpec("p95_latency_s", "higher", 0.20, noisy=True),
        MetricSpec("ttft_p50_s", "higher", 0.15, noisy=True),
        MetricSpec("ttft_p95_s", "higher", 0.20, noisy=True),
        # step-clock TTFT (chunked prefill): a pure function of the seeded
        # request trace + scheduler config, so ANY growth regresses — this
        # is the tight signal; the wall TTFTs above absorb machine noise
        MetricSpec("ttft_p50_steps", "higher", 0.0),
        MetricSpec("ttft_p95_steps", "higher", 0.0),
        MetricSpec("prefill_chunk", "lower", 0.0),
        MetricSpec("slot_utilization", "lower", 0.02),
        MetricSpec("fused_steps", "higher", 0.0),
        MetricSpec("requests", "lower", 0.0),
        MetricSpec("new_tokens", "lower", 0.0),
        # scenario-cell counters: given the seeded trace these are exact,
        # so ANY movement regresses — a new rejection, preemption, or
        # restart under the same spec is a behavior change, not noise.
        # (golden_ok / slo_ok are booleans: _judge regresses True -> False
        # before any spec lookup.)
        MetricSpec("rejected", "higher", 0.0),
        MetricSpec("preemptions", "higher", 0.0),
        MetricSpec("restarts", "higher", 0.0),
        # block-pool dedup counters: deterministic given the trace.  The
        # dedup ratio falling (or physical blocks growing) means prefix
        # sharing stopped finding matches or COW started copying more —
        # the memory-side Eq. 1 regression
        MetricSpec("block_dedup_ratio", "lower", 0.0),
        MetricSpec("physical_blocks", "higher", 0.0),
        MetricSpec("logical_blocks", "lower", 0.0),
        MetricSpec("shared_block_hits", "lower", 0.0),
        MetricSpec("cow_copies", "higher", 0.0),
        MetricSpec("kv_bytes_served", "lower", 0.0),
        MetricSpec("kv_bytes_stored", "higher", 0.0),
        # speculative decoding: all exact given the trace, so tol 0.
        # acceptance_rate falling is the Eq. 1 regression (fewer active
        # lanes per k-wide verification issue); more rejected tokens,
        # more draft calls, or more target fused calls for the same
        # traffic all mean speculation got less effective.
        MetricSpec("acceptance_rate", "lower", 0.0),
        MetricSpec("drafted_tokens", "lower", 0.0),
        MetricSpec("accepted_tokens", "lower", 0.0),
        MetricSpec("rejected_tokens", "higher", 0.0),
        MetricSpec("draft_steps", "higher", 0.0),
        MetricSpec("target_steps", "higher", 0.0),
        MetricSpec("spec_k", "lower", 0.0),
        # tensor-parallel serving: both exact given the trace + mesh shape
        # (each +mesh<DxM> fork is its own trajectory).  The worst device
        # shard's busy-lane fraction falling means the mesh started
        # idling a device's lanes — Eq. 1's regression one level up.
        MetricSpec("device_lane_utilization", "lower", 0.0),
        MetricSpec("mesh_devices", "lower", 0.0),
    )
}


@dataclasses.dataclass(frozen=True)
class MetricDelta:
    """One (workload key, metric) movement between baseline and run."""

    key: str
    metric: str
    before: Any
    after: Any
    rel_delta: float  # signed (after - before) / |before|; +-inf from a 0 baseline
    tol: float
    regressed: bool
    improved: bool

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if isinstance(d["rel_delta"], float) and not math.isfinite(d["rel_delta"]):
            d["rel_delta"] = None  # undefined vs a zero baseline; keep JSON strict
        return d


@dataclasses.dataclass(frozen=True)
class Regression:
    """A delta that moved past tolerance in the worse direction."""

    key: str
    metric: str
    before: Any
    after: Any
    rel_delta: float
    tol: float

    @property
    def severity(self) -> float:
        """How far past tolerance the movement went (>= 0)."""
        return max(0.0, abs(self.rel_delta) - self.tol)

    def describe(self) -> str:
        return (
            f"{self.key}: {self.metric} {self.before} -> {self.after} "
            f"({self.rel_delta:+.1%}, tol {self.tol:.0%})"
        )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["severity"] = self.severity
        for k in ("rel_delta", "severity"):
            if isinstance(d[k], float) and not math.isfinite(d[k]):
                d[k] = None  # counter sprang from a zero baseline; keep JSON strict
        return d


@dataclasses.dataclass
class RunComparison:
    """Everything ``compare_runs`` derives about (baseline, run)."""

    baseline_id: str
    run_id: str
    deltas: List[MetricDelta]
    regressions: List[Regression]
    improvements: List[MetricDelta]
    new_keys: List[str]
    missing_keys: List[str]
    # per-metric coverage drift within shared keys: "<key>.<metric>" names
    # present only in the baseline (vanished — a gated metric silently
    # disappearing must be visible) or only in the run (new)
    missing_metrics: List[str] = dataclasses.field(default_factory=list)
    new_metrics: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.regressions

    def to_dict(self) -> Dict[str, Any]:
        return {
            "baseline_id": self.baseline_id,
            "run_id": self.run_id,
            "ok": self.ok,
            "regressions": [r.to_dict() for r in self.regressions],
            "improvements": [d.to_dict() for d in self.improvements],
            "deltas": [d.to_dict() for d in self.deltas],
            "new_keys": self.new_keys,
            "missing_keys": self.missing_keys,
            "missing_metrics": self.missing_metrics,
            "new_metrics": self.new_metrics,
        }


def _judge(
    spec: Optional[MetricSpec], before: Any, after: Any, wall_tol_scale: float
) -> Tuple[float, float, bool, bool]:
    """(rel_delta, tol, regressed, improved) for one metric pair."""
    if isinstance(before, bool) or isinstance(after, bool):
        regressed = bool(before) and not bool(after)
        improved = not bool(before) and bool(after)
        return (0.0 if before == after else (1.0 if improved else -1.0),
                0.0, regressed, improved)
    if not isinstance(before, (int, float)) or not isinstance(after, (int, float)):
        # configs and other identity metrics: drift is context for the
        # triage, never a regression by itself
        return 0.0, 0.0, False, False
    if before == 0:
        # no relative judgement exists against a zero baseline (a rounded
        # 0.000s wall time would read epsilon-nonzero as an astronomical
        # regression); report the movement, never gate on it — EXCEPT for
        # exact counters (rel_tol 0), where zero is a real value, not a
        # rounding artifact: the first rejection/preemption/restart under
        # an unchanged spec is a behavior change and must gate
        rel = 0.0 if after == 0 else math.copysign(float("inf"), after)
        if spec is not None and spec.rel_tol == 0 and after != 0:
            worse = rel > 0 if spec.worse == "higher" else rel < 0
            return rel, 0.0, worse, not worse
        return rel, 0.0, False, False
    rel = (after - before) / abs(before)
    if spec is None:
        return rel, 0.0, False, False  # untracked metric: informational
    tol = spec.rel_tol * (wall_tol_scale if spec.noisy else 1.0)
    worse = rel > tol if spec.worse == "higher" else rel < -tol
    better = rel < -tol if spec.worse == "higher" else rel > tol
    return rel, tol, worse, better


def compare_runs(
    baseline: BenchRun,
    run: BenchRun,
    *,
    wall_tol_scale: float = 1.0,
    specs: Optional[Mapping[str, MetricSpec]] = None,
) -> RunComparison:
    """Judge ``run`` against ``baseline`` metric by metric.

    Workload keys present only in one run are reported (``new_keys`` /
    ``missing_keys``) but never gate: recording a different benchmark
    subset is an operator choice, not a regression.  ``wall_tol_scale``
    multiplies the tolerance of every noisy (timing) metric — CI runners
    pass > 1 to absorb shared-machine scheduling noise without loosening
    the deterministic counter contract.
    """
    specs = SPECS if specs is None else specs
    deltas: List[MetricDelta] = []
    regressions: List[Regression] = []
    improvements: List[MetricDelta] = []
    missing_metrics: List[str] = []
    new_metrics: List[str] = []
    common = [k for k in baseline.metrics if k in run.metrics]
    for key in common:
        before_m, after_m = baseline.metrics[key], run.metrics[key]
        new_metrics.extend(f"{key}.{n}" for n in after_m if n not in before_m)
        for name in before_m:
            if name not in after_m:
                missing_metrics.append(f"{key}.{name}")
                continue
            rel, tol, worse, better = _judge(
                specs.get(name), before_m[name], after_m[name], wall_tol_scale
            )
            delta = MetricDelta(
                key=key, metric=name, before=before_m[name],
                after=after_m[name], rel_delta=rel, tol=tol,
                regressed=worse, improved=better,
            )
            deltas.append(delta)
            if worse:
                regressions.append(Regression(
                    key=key, metric=name, before=before_m[name],
                    after=after_m[name], rel_delta=rel, tol=tol,
                ))
            elif better:
                improvements.append(delta)
    regressions.sort(key=lambda r: -r.severity)
    return RunComparison(
        baseline_id=baseline.run_id,
        run_id=run.run_id,
        deltas=deltas,
        regressions=regressions,
        improvements=improvements,
        new_keys=sorted(set(run.metrics) - set(baseline.metrics)),
        missing_keys=sorted(set(baseline.metrics) - set(run.metrics)),
        missing_metrics=sorted(missing_metrics),
        new_metrics=sorted(new_metrics),
    )
