"""One-call SVE analysis pipeline: Workload -> SVEAnalysis (a port of
:mod:`repro.analysis.pipeline`).

Implements the paper's end-to-end method (Sec. 3): ``analyze(workload)``
chains PMU-analogue events (``core.counters``, paper Sec. 3.1 / Table 1),
Eq. 1 metrics (VB, R_ins, AI — Sec. 3.3), the adapted roofline (Eq. 2)
and the Fig. 8 decision tree into a single call that returns a typed,
serializable report, with an optional ROI timed on the workload's device.

Event sources: the workload's analytic flops/bytes model (``"analytic"``,
which ``"auto"`` resolves to).  The reference's ``"compiled"`` source (XLA
artifacts), its persistent artifact cache and store, and its autotuner
outlook are not ported: asking for them raises, naming ROADMAP 1.17, and
``SVEAnalysis.tuning`` stays ``None``.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import torch

from repro_torch.analysis.workload import Workload, get_workload, list_workloads
from repro_torch.core import hw, metrics
from repro_torch.core.counters import Events, events_from_analytic
from repro_torch.core.decision_tree import Decision, PerfClass, classify
from repro_torch.core.device import resolve_device
from repro_torch.core.metrics import VectorizationReport
from repro_torch.core.profiler import Profiler, block_until_ready
from repro_torch.core.roofline import AdaptedRoofline, adapted_roofline

WorkloadLike = Union[str, Workload]

_UNPORTED = "not ported yet: {} is ROADMAP item 1.17"


# ---------------------------------------------------------------------------
# The typed report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SVEAnalysis:
    """Everything the paper derives about one workload on one chip model.

    ``tuning`` is always ``None`` in the port: the autotuner is not ported
    yet (ROADMAP 1.17).
    """

    workload: str
    chip: str
    dtype: str
    source: str  # "analytic" | "compiled" (analyze_events)
    events: Events
    report: VectorizationReport
    roofline: AdaptedRoofline
    decision: Decision
    wall_s: Optional[float] = None
    tuning: Optional[Dict[str, Any]] = None

    # -- the paper's headline quantities, flattened -------------------------
    @property
    def vb(self) -> float:
        return self.roofline.vb

    @property
    def r_ins(self) -> float:
        return self.report.r_ins

    @property
    def ai(self) -> float:
        return self.report.ai

    @property
    def ai_inflection(self) -> float:
        return self.decision.ai_inflection

    @property
    def perf_class(self) -> PerfClass:
        return self.decision.perf_class

    @property
    def bound(self) -> str:
        """Adapted-roofline region: "memory-bound" or "compute-bound"."""
        return self.roofline.region(self.ai)

    @property
    def predicted_speedup(self) -> float:
        return self.roofline.predicted_speedup(self.ai)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "workload": self.workload,
            "chip": self.chip,
            "dtype": self.dtype,
            "source": self.source,
            "vb": self.vb,
            "r_ins": self.r_ins,
            "ai": self.ai,
            "ai_inflection": self.ai_inflection,
            "bound": self.bound,
            "predicted_speedup": self.predicted_speedup,
            "perf_class": int(self.perf_class),
            "perf_class_name": self.perf_class.name,
            "rationale": self.decision.rationale,
            "gather_fraction": self.report.gather_fraction,
            "vectorizable_fraction": self.report.vectorizable_fraction,
            "flops": self.report.flops,
            "hbm_bytes": self.report.hbm_bytes,
            "wall_s": self.wall_s,
            "events": self.events.to_dict(),
            "roofline": dataclasses.asdict(self.roofline),
            "tuning": self.tuning,
        }

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    def row(self) -> Dict[str, Any]:
        """One flat table row (the CSV/pretty-print projection)."""
        return {
            "workload": self.workload,
            "chip": self.chip,
            "dtype": self.dtype,
            "vb": f"{self.vb:.0f}",
            "r_ins": f"{self.r_ins:.3g}",
            "ai": f"{self.ai:.4g}",
            "knee": f"{self.ai_inflection:.4g}",
            "bound": self.bound,
            "class": f"{int(self.perf_class)} {self.perf_class.name}",
            "speedup_pred": f"{self.predicted_speedup:.3g}",
            "tuned": "",
            "wall_s": "" if self.wall_s is None else f"{self.wall_s:.5f}",
        }

    def table(self) -> str:
        return format_table([self])

    def __str__(self) -> str:
        return (
            f"[{self.workload} @ {self.chip}/{self.dtype}] "
            f"VB={self.vb:.0f} R_ins={self.r_ins:.3g} AI={self.ai:.4g} "
            f"({self.bound}) Class {int(self.perf_class)} "
            f"({self.perf_class.describe()})"
        )


def format_table(results: Sequence[SVEAnalysis]) -> str:
    """Pretty fixed-width table over ``SVEAnalysis.row()`` projections."""
    rows = [r.row() for r in results]
    if not rows:
        return "(no results)"
    keys = list(rows[0].keys())
    widths = {k: max(len(k), *(len(str(r[k])) for r in rows)) for k in keys}
    lines = ["  ".join(k.ljust(widths[k]) for k in keys)]
    for r in rows:
        lines.append("  ".join(str(r[k]).ljust(widths[k]) for k in keys))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def _resolve(wl: WorkloadLike) -> Workload:
    return get_workload(wl) if isinstance(wl, str) else wl


def _report_from_events(
    name: str, dtype: str, ev: Events, chip: hw.ChipSpec
) -> VectorizationReport:
    """Eq.-1 report from events: scalar baseline = one element per issue
    slot; effective R_ins = Amdahl over the vectorizable FLOP share."""
    vb = metrics.vectorization_bound(chip, dtype)
    r_eff = metrics.amdahl_r_ins(vb, ev.vectorizable_fraction)
    ins_scalar = ev.flops / 2.0
    return VectorizationReport(
        name=name,
        dtype=dtype,
        flops=ev.flops,
        hbm_bytes=ev.bytes_accessed,
        gather_bytes=ev.gather_bytes,
        ins_scalar=ins_scalar,
        ins_vec=ins_scalar / max(r_eff, 1e-30),
        vectorizable_fraction=ev.vectorizable_fraction,
        collective_bytes=ev.collective_bytes,
    )


def _time_roi(wl: Workload, device: torch.device) -> Optional[float]:
    """ROI wall time through the paper's profiler API (Sec. 3.1): one warm
    call, then one timed call, each waited for on the card."""
    if wl.fn is None:
        return None
    args = wl.args_on(device)
    prof = Profiler()
    prof.configure_measure()
    block_until_ready(wl.fn(*args))  # warm-up (and kernel build) outside
    prof.start_measure()
    block_until_ready(wl.fn(*args))
    prof.stop_measure()
    return prof.mean_roi_s()


def analyze(
    wl: WorkloadLike,
    chip: hw.ChipSpec = hw.GRACE_CORE,
    *,
    dtype: Optional[str] = None,
    source: str = "auto",
    time_roi: bool = False,
    device: Union[str, torch.device] = "cuda",
    cache: Any = None,
    store: Any = None,
) -> SVEAnalysis:
    """Run the paper's full method on one workload, on one chip model.

    Analytic events -> Eq. 1 metrics -> adapted roofline (Eq. 2) -> Fig. 8
    decision tree, plus, with ``time_roi``, the workload's ROI timed on
    ``device`` (its example arguments are moved there once).  ``device``
    is read only by the timing.
    """
    if cache is not None or store is not None:
        raise ValueError(_UNPORTED.format("the artifact cache/store"))
    wl = _resolve(wl)
    dtype = dtype or wl.dtype
    if source not in ("auto", "analytic", "compiled"):
        raise ValueError(f"source must be auto|analytic|compiled, got {source!r}")
    if source == "compiled" or not wl.has_analytic_model:
        raise ValueError(_UNPORTED.format(
            f"{wl.name}: the compiled event source"))
    ev = events_from_analytic(
        flops=wl.flops,
        hbm_bytes=wl.hbm_bytes,
        gather_bytes=wl.gather_bytes,
        collective_bytes=wl.collective_bytes,
        n_devices=wl.n_devices,
    )
    ev.nonvec_flops = wl.flops * (1.0 - wl.vectorizable_fraction)
    report = wl.report(chip, dtype=dtype)
    rl = adapted_roofline(chip, dtype)
    decision = classify(report, chip, roofline=rl)
    wall = _time_roi(wl, resolve_device(device)) if time_roi else None
    return SVEAnalysis(
        workload=wl.name,
        chip=chip.name,
        dtype=dtype,
        source="analytic",
        events=ev,
        report=report,
        roofline=rl,
        decision=decision,
        wall_s=wall,
    )


def analyze_events(
    name: str,
    events: Events,
    chip: hw.ChipSpec = hw.GRACE_CORE,
    *,
    dtype: str = "fp32",
) -> SVEAnalysis:
    """The pipeline's tail for callers that already hold Events."""
    report = _report_from_events(name, dtype, events, chip)
    rl = adapted_roofline(chip, dtype)
    return SVEAnalysis(
        workload=name,
        chip=chip.name,
        dtype=dtype,
        source="compiled",
        events=events,
        report=report,
        roofline=rl,
        decision=classify(report, chip, roofline=rl),
    )


def analyze_sweep(
    workloads: Optional[Iterable[WorkloadLike]] = None,
    chips: Sequence[hw.ChipSpec] = (hw.GRACE_CORE, hw.TPU_V5E),
    *,
    dtypes: Optional[Sequence[str]] = None,
    source: str = "auto",
    time_roi: bool = False,
    device: Union[str, torch.device] = "cuda",
    jobs: int = 1,
) -> List[SVEAnalysis]:
    """``analyze`` over a (workload x chip x dtype) grid.

    ``workloads`` defaults to every registered workload; ``dtypes`` defaults
    to each workload's own dtype.  ``jobs > 1`` fans the cells over a
    thread pool; results come back in the serial (workload, chip, dtype)
    order.
    """
    names = list(workloads) if workloads is not None else list_workloads()
    cells: List[tuple] = []
    for w in names:
        wl = _resolve(w)
        for chip in chips:
            for dtype in dtypes or (wl.dtype,):
                cells.append((wl, chip, dtype))

    def run_cell(cell: tuple) -> SVEAnalysis:
        wl, chip, dtype = cell
        return analyze(wl, chip, dtype=dtype, source=source,
                       time_roi=time_roi, device=device)

    if jobs <= 1 or len(cells) <= 1:
        return [run_cell(c) for c in cells]
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        return list(pool.map(run_cell, cells))
