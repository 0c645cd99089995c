"""Regression triage: explain each regression with the paper's analytics.

A gate that says "8% slower" sends the engineer off to bisect; the paper's
Fig. 8 decision tree can usually say *why*.  For every regressed workload
whose BenchRun metrics carry the analytic quantities (AI, R_ins, traffic,
gather share), the triage re-runs :func:`repro_torch.core.decision_tree.classify`
on both the baseline point and the regressed point, reads the Eq. 2
inflection points off :func:`repro_torch.core.roofline.adapted_roofline`
(the port's copies of the reference's), and reports the class transition in the paper's own terms:

    kernel/gemm@grace-core/fp32: slipped from Class 4 (SPEEDUP) to
    Class 2 (MEMORY_BANDWIDTH_BOUND): AI fell 42.7 -> 0.67, left of
    AI_IRV=0.833 (AI_IRR=0.208); hbm_bytes grew 64.0x

plus a suspect list: a tuned-config change between the runs, a stale
tuning record (the tuning store's best configs for that kernel all differ
from the config the run used — found by enumerating the store through
:meth:`~repro_torch.analysis.store.ArtifactStore.iter_json`), a git SHA
change, or — when every deterministic counter is unchanged — plain
wall-clock noise.  A port of :mod:`repro.perf.triage`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core import hw
from repro_torch.core.decision_tree import Decision, PerfClass, classify
from repro_torch.core.metrics import VectorizationReport
from repro_torch.core.roofline import adapted_roofline
from repro_torch.perf.compare import Regression, RunComparison
from repro_torch.perf.ledger import BenchRun, _config_token

#: Metric names whose values are deterministic counters (not wall noise).
_COUNTER_METRICS = (
    "ai", "r_ins", "flops", "hbm_bytes", "gather_bytes",
    "vectorizable_fraction", "perf_class", "predicted_speedup", "rows",
) + (
    # serving scheduler counters: pure functions of the seeded request
    # trace + scheduler config, so their movement is a behavior change
    "fused_steps", "busy_slot_steps", "slot_steps", "slot_utilization",
    "ttft_p50_steps", "ttft_p95_steps", "prefill_chunk",
    "preemptions", "rejected", "restarts", "requests", "new_tokens",
)

#: The subset that the continuous scheduler's admission/chunking/budget
#: policy controls directly — regressions here get a scheduling suspect.
_SCHED_METRICS = (
    "fused_steps", "busy_slot_steps", "slot_steps",
    "ttft_p50_steps", "ttft_p95_steps", "prefill_chunk",
)


def split_key(key: str) -> Tuple[str, Optional[str], Optional[str]]:
    """``"kernel/gemm@grace-core/fp32"`` -> (workload, chip, dtype)."""
    if "@" not in key:
        return key, None, None
    workload, _, rest = key.partition("@")
    chip, _, dtype = rest.partition("/")
    return workload, chip or None, dtype or None


def report_from_metrics(
    key: str, m: Mapping[str, Any], dtype: str
) -> Optional[VectorizationReport]:
    """Rebuild the decision tree's input from one stored metric dict.

    ``r_ins`` is stored directly, so the scalar/vector issue counts are
    reconstructed as (r_ins, 1) — ``instruction_reduction`` is their ratio
    and nothing downstream reads the absolute counts.
    """
    if "flops" not in m or "hbm_bytes" not in m:
        return None
    return VectorizationReport(
        name=key,
        dtype=dtype,
        flops=float(m["flops"]),
        hbm_bytes=float(m["hbm_bytes"]),
        gather_bytes=float(m.get("gather_bytes", 0.0)),
        ins_scalar=float(m.get("r_ins", 1.0)),
        ins_vec=1.0,
        vectorizable_fraction=float(m.get("vectorizable_fraction", 1.0)),
    )


@dataclasses.dataclass(frozen=True)
class Triage:
    """The explained form of one workload's regression(s)."""

    key: str
    metrics: Tuple[str, ...]  # regressed metric names
    class_before: Optional[PerfClass]
    class_after: Optional[PerfClass]
    decision_before: Optional[Decision]
    decision_after: Optional[Decision]
    ai_before: Optional[float]
    ai_after: Optional[float]
    ai_irr: Optional[float]
    ai_irv: Optional[float]
    suspects: Tuple[str, ...]
    narrative: str

    @property
    def class_transition(self) -> Optional[str]:
        if self.class_before is None or self.class_after is None:
            return None
        return (
            f"Class {int(self.class_before)} ({self.class_before.name}) -> "
            f"Class {int(self.class_after)} ({self.class_after.name})"
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "key": self.key,
            "metrics": list(self.metrics),
            "class_before": None if self.class_before is None else int(self.class_before),
            "class_after": None if self.class_after is None else int(self.class_after),
            "class_transition": self.class_transition,
            "ai_before": self.ai_before,
            "ai_after": self.ai_after,
            "ai_irr": self.ai_irr,
            "ai_irv": self.ai_irv,
            "rationale_after": (
                None if self.decision_after is None else self.decision_after.rationale
            ),
            "suspects": list(self.suspects),
            "narrative": self.narrative,
        }


# ---------------------------------------------------------------------------
# Suspects
# ---------------------------------------------------------------------------


def _store_configs(tuning_store: Any) -> Dict[Tuple[str, str, str], set]:
    """(kernel, chip, dtype) -> set of persisted config tokens.

    Enumerates the tuning store through ``iter_json``: the payloads carry
    the identity triple (``tuning_version`` 1, ``record.{kernel,chip,dtype,
    config}``), so a run is suspect only when its config matches none of
    the store's known-best configs for its triple.  ``"default"`` is the
    port's tuning store, ``<the port's artifact dir>/tuning``, which
    ``repro_torch.tuning`` writes; the payloads are the reference's, so a
    store the reference's ``save_record`` wrote reads the same.  A store
    that cannot be opened gives no configs (triage is advisory and never
    raises).
    """
    from repro_torch.tuning.records import TUNING_VERSION, resolve_store

    out: Dict[Tuple[str, str, str], set] = {}
    try:
        store = resolve_store(tuning_store)
    except Exception:  # noqa: BLE001 — triage is advisory, never raises
        return out
    if store is None:
        return out
    for _, payload in store.iter_json():
        if payload.get("tuning_version") != TUNING_VERSION:
            continue
        rec = payload.get("record") or {}
        triple = (str(rec.get("kernel")), str(rec.get("chip")), str(rec.get("dtype")))
        out.setdefault(triple, set()).add(_config_token(rec.get("config") or {}))
    return out


def _suspects(
    key: str,
    regressed: List[Regression],
    before_m: Mapping[str, Any],
    after_m: Mapping[str, Any],
    baseline: BenchRun,
    run: BenchRun,
    store_configs: Mapping[Tuple[str, str, str], set],
) -> List[str]:
    out: List[str] = []
    workload, chip, dtype = split_key(key)
    kernel = workload.rsplit("/", 1)[-1]
    cfg_before = before_m.get("config")
    cfg_after = after_m.get("config")
    if cfg_before != cfg_after:
        out.append(f"tuned config changed: {cfg_before!r} -> {cfg_after!r}")
    store_cfgs = store_configs.get((kernel, chip or "", dtype or ""))
    if store_cfgs and cfg_after is not None and cfg_after not in store_cfgs:
        known = ", ".join(repr(c) for c in sorted(store_cfgs))
        out.append(
            f"stale TuningRecord: run used {cfg_after!r}, store best is "
            f"{known} — re-run `python -m repro_torch.tuning`"
        )
    if baseline.env.tuned_hash != run.env.tuned_hash:
        out.append(
            f"active tuned-config set changed "
            f"({baseline.env.tuned_hash or 'none'} -> {run.env.tuned_hash or 'none'})"
        )
    if baseline.env.git_sha != run.env.git_sha:
        out.append(
            f"code changed: {baseline.env.git_sha} -> {run.env.git_sha}"
        )
    hbm_b, hbm_a = before_m.get("hbm_bytes"), after_m.get("hbm_bytes")
    if (isinstance(hbm_b, (int, float)) and isinstance(hbm_a, (int, float))
            and hbm_b > 0 and hbm_a > hbm_b * 1.02):
        out.append(f"HBM traffic grew {hbm_a / hbm_b:.3g}x")
    sched = sorted({r.metric for r in regressed if r.metric in _SCHED_METRICS})
    if sched:
        out.append(
            "deterministic scheduler counters moved ("
            + ", ".join(sched)
            + "): admission/chunking/budget policy changed, not machine noise"
        )
    if not any(r.metric in _COUNTER_METRICS for r in regressed):
        out.append(
            "wall-time regression with unchanged counters: suspect machine "
            "noise or runtime environment, not the kernel"
        )
    return out


# ---------------------------------------------------------------------------
# The triage pass
# ---------------------------------------------------------------------------


def _triage_one(
    key: str,
    regressed: List[Regression],
    baseline: BenchRun,
    run: BenchRun,
    store_configs: Mapping[Tuple[str, str, str], set],
) -> Triage:
    before_m = baseline.metrics.get(key) or {}
    after_m = run.metrics.get(key) or {}
    workload, chip_name, dtype = split_key(key)
    dtype = dtype or run.env.dtype
    chip: Optional[hw.ChipSpec] = None
    try:
        chip = hw.get_chip(chip_name or run.env.chip)
    except KeyError:
        chip = None

    dec_before = dec_after = None
    rl = None
    if chip is not None:
        rl = adapted_roofline(chip, dtype)
        rep_before = report_from_metrics(key, before_m, dtype)
        rep_after = report_from_metrics(key, after_m, dtype)
        if rep_before is not None:
            dec_before = classify(rep_before, chip, roofline=rl)
        if rep_after is not None:
            dec_after = classify(rep_after, chip, roofline=rl)

    suspects = _suspects(
        key, regressed, before_m, after_m, baseline, run, store_configs
    )
    names = tuple(r.metric for r in regressed)

    # -- narrative: the paper's terms first, raw deltas second --------------
    parts: List[str] = []
    if dec_before is not None and dec_after is not None and rl is not None:
        if dec_after.perf_class != dec_before.perf_class:
            verb = ("slipped" if dec_after.perf_class < dec_before.perf_class
                    else "moved")
            parts.append(
                f"{verb} from Class {int(dec_before.perf_class)} "
                f"({dec_before.perf_class.name}) to Class "
                f"{int(dec_after.perf_class)} ({dec_after.perf_class.name})"
            )
        else:
            parts.append(
                f"stays Class {int(dec_after.perf_class)} "
                f"({dec_after.perf_class.name})"
            )
        side = "left" if dec_after.ai < rl.ai_irv else "right"
        moved = "fell" if dec_after.ai < dec_before.ai else "sits"
        parts.append(
            f"AI {moved} {dec_before.ai:.3g} -> {dec_after.ai:.3g}, {side} of "
            f"AI_IRV={rl.ai_irv:.3g} (AI_IRR={rl.ai_irr:.3g})"
        )
    else:
        parts.append(
            "regressed: " + "; ".join(r.describe() for r in regressed[:3])
        )
    if suspects:
        parts.append("suspect " + "; ".join(suspects))
    narrative = f"{key}: " + "; ".join(parts)

    return Triage(
        key=key,
        metrics=names,
        class_before=None if dec_before is None else dec_before.perf_class,
        class_after=None if dec_after is None else dec_after.perf_class,
        decision_before=dec_before,
        decision_after=dec_after,
        ai_before=None if dec_before is None else dec_before.ai,
        ai_after=None if dec_after is None else dec_after.ai,
        ai_irr=None if rl is None else rl.ai_irr,
        ai_irv=None if rl is None else rl.ai_irv,
        suspects=tuple(suspects),
        narrative=narrative,
    )


def triage_regressions(
    comparison: RunComparison,
    baseline: BenchRun,
    run: BenchRun,
    *,
    tuning_store: Any = "default",
) -> List[Triage]:
    """One :class:`Triage` per regressed workload key, gate-severity order.

    ``tuning_store`` feeds the staleness check (``"default"`` for the
    shared store, a directory, an ArtifactStore, or ``None`` to skip it).
    """
    by_key: Dict[str, List[Regression]] = {}
    for reg in comparison.regressions:
        by_key.setdefault(reg.key, []).append(reg)
    store_configs = _store_configs(tuning_store) if by_key else {}
    return [
        _triage_one(key, regs, baseline, run, store_configs)
        for key, regs in by_key.items()
    ]
