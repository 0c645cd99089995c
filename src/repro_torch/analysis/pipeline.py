"""One-call SVE analysis pipeline: Workload -> SVEAnalysis (a port of
:mod:`repro.analysis.pipeline`).

Implements the paper's end-to-end method (Sec. 3): ``analyze(workload)``
chains PMU-analogue events (``core.counters``, paper Sec. 3.1 / Table 1),
Eq. 1 metrics (VB, R_ins, AI — Sec. 3.3), the adapted roofline (Eq. 2)
and the Fig. 8 decision tree into a single call that returns a typed,
serializable report, with an optional ROI timed on the workload's device.

Event sources (``source=``):

* ``"analytic"`` — the workload's Sec.-3.3-style flops/bytes model;
* ``"compiled"`` — record one run of the workload's callable on the CPU
  and walk the recording (``core.op_cost``, ``counters.
  events_from_compiled``): the port's counterpart of the reference's XLA
  artifact, for any PyTorch callable;
* ``"auto"`` (default) — analytic when the model is present, else compiled.

``analyze_sweep`` amortizes recording: events are chip-independent
(GLOBAL quantities), so a multi-chip / multi-ELEN sweep records each
workload exactly once via ``ArtifactCache`` — and, backed by the
persistent :class:`~repro_torch.analysis.store.ArtifactStore`, at most
once across *processes*.  ``analyze_sweep(..., jobs=N)`` fans the
(workload x chip x dtype) cells over a thread pool; single-flight
deduplication in the cache makes concurrent cells of the same workload
wait on one recording rather than race.  Kernel workloads also
carry the autotuner's tuned-vs-default outlook (``SVEAnalysis.tuning``, see
:mod:`repro_torch.tuning`).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import torch

from repro_torch.analysis.store import (
    ArtifactStore, _store_for, default_store, workload_fingerprint,
)
from repro_torch.analysis.workload import Workload, get_workload, list_workloads
from repro_torch.core import hw, metrics
from repro_torch.core.counters import (
    Events, events_from_analytic, events_from_compiled,
)
from repro_torch.core.decision_tree import Decision, PerfClass, classify
from repro_torch.core.device import resolve_device
from repro_torch.core.metrics import VectorizationReport
from repro_torch.core.op_cost import Recording, record
from repro_torch.core.profiler import Profiler, block_until_ready
from repro_torch.core.roofline import AdaptedRoofline, adapted_roofline

WorkloadLike = Union[str, Workload]

#: Sentinel: resolve ``store.default_store()`` lazily, at first use (so the
#: ``$REPRO_ARTIFACT_DIR`` override is honored even for module-level caches).
DEFAULT_STORE = "default"


# ---------------------------------------------------------------------------
# Recorded-artifact cache (the sweep's record-once guarantee)
# ---------------------------------------------------------------------------


class ArtifactCache:
    """In-memory + optionally disk-backed cache of per-workload Events.

    Events are chip-independent (global flops/bytes/collective quantities),
    so one recording serves every (chip, dtype) cell of a sweep.  Lookups
    are **single-flight**: under a parallel sweep, concurrent cells for the
    same workload block on one leader's recording instead of recording N
    times.

    ``store`` adds a persistent layer keyed by workload fingerprint (see
    :mod:`repro_torch.analysis.store`): pass an :class:`ArtifactStore`, the
    :data:`DEFAULT_STORE` sentinel for the shared default directory, any
    other string as a directory path, or ``None`` (default) for a
    process-local, memory-only cache.

    ``compiles`` (recordings, under the reference's name) / ``hits`` /
    ``store_hits`` are exposed for tests and cost accounting (``hits``
    counts in-memory hits only); ``record_s`` sums the recordings' seconds.
    """

    def __init__(self, store: Union[ArtifactStore, str, None] = None) -> None:
        # keyed by fingerprint (content address), not object identity: two
        # workloads sharing a name but differing in shapes/dtypes/body get
        # different keys, and the cache never pins request Workloads (and
        # their example tensors) for the process lifetime
        self._events: Dict[str, Events] = {}
        self._store = store
        self._lock = threading.Lock()
        self._inflight: Dict[str, threading.Event] = {}
        self.compiles = 0
        self.hits = 0
        self.store_hits = 0
        self.record_s = 0.0

    @property
    def store(self) -> Optional[ArtifactStore]:
        if isinstance(self._store, str):
            if self._store == DEFAULT_STORE:
                return default_store()
            return _store_for(self._store)  # one store per directory
        return self._store

    def events_for(self, wl: Workload) -> Events:
        if wl.fn is None:
            raise ValueError(f"{wl.name}: no callable to record")
        key = workload_fingerprint(wl)
        while True:
            with self._lock:
                if key in self._events:
                    self.hits += 1
                    return self._events[key]
                flight = self._inflight.get(key)
                if flight is None:
                    # become the leader for this workload
                    self._inflight[key] = threading.Event()
                    break
            # another thread is recording this workload: wait, then re-check
            # (if the leader failed, the loop elects a new leader)
            flight.wait()
        try:
            ev = self._load_or_record(wl, key)
            with self._lock:
                self._events[key] = ev
            return ev
        finally:
            with self._lock:
                self._inflight.pop(key).set()

    def _load_or_record(self, wl: Workload, fingerprint: str) -> Events:
        store = self.store
        if store is not None:
            ev = store.get(fingerprint)
            if ev is not None:
                with self._lock:
                    self.store_hits += 1
                return ev
        with self._lock:
            self.compiles += 1
        rec = record(wl.fn, wl.example_args())
        with self._lock:
            self.record_s += rec.seconds
        ev = events_from_compiled(rec, n_devices=wl.n_devices)
        if store is not None:
            store.put(fingerprint, ev, workload=wl.name)
        return ev

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.compiles = 0
            self.hits = 0
            self.store_hits = 0
            self.record_s = 0.0


#: Module-level default cache shared by bare ``analyze`` calls — persistent
#: across processes via the default ArtifactStore.
DEFAULT_CACHE = ArtifactCache(store=DEFAULT_STORE)


# ---------------------------------------------------------------------------
# The typed report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SVEAnalysis:
    """Everything the paper derives about one workload on one chip model.

    ``tuning`` (kernel workloads only) is the autotuner's analytic outlook:
    the default vs roofline-best launch variant, the predicted tuned-vs-
    default speedup, and — when the tuning store already holds a record for
    this (kernel, chip, dtype) — the persisted winning config.
    """

    workload: str
    chip: str
    dtype: str
    source: str  # "analytic" | "compiled"
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
            "tuned": (
                "" if not self.tuning
                else f"{self.tuning['predicted_speedup']:.3g}x"
            ),
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


def _tuning_outlook(
    wl: Workload, chip: hw.ChipSpec, dtype: str
) -> Optional[Dict[str, Any]]:
    """Autotuner outlook for kernel workloads (model + store lookup only —
    never records or times; never raises into the analysis)."""
    if not wl.name.startswith("kernel/"):
        return None
    try:
        from repro_torch.kernels.registry import KERNELS

        ops = KERNELS.get(wl.name[len("kernel/"):])
        if ops is None or ops.tuning_space is None:
            return None
        from repro_torch.tuning import outlook

        return outlook(ops, wl.example_args(), chip, dtype=dtype)
    except Exception:  # noqa: BLE001 — the outlook is advisory, not load-bearing
        return None


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
    cache: Optional[ArtifactCache] = None,
    store: Union[ArtifactStore, str, None] = None,
) -> SVEAnalysis:
    """Run the paper's full method on one workload, on one chip model.

    Events (analytic, or recorded once and cached) -> Eq. 1 metrics ->
    adapted roofline (Eq. 2) -> Fig. 8 decision tree, plus, with
    ``time_roi``, the workload's ROI timed on ``device`` (its example
    arguments are moved there once).  ``device`` is read only by the
    timing: recordings run on the CPU (:mod:`repro_torch.core.op_cost`).
    Kernel workloads carry the autotuner's roofline-predicted tuned-vs-
    default speedup and any persisted tuned config (``result.tuning``).

    Without ``cache``, events come from the module-level ``DEFAULT_CACHE``
    (persistent via the default ArtifactStore, so repeat processes record
    nothing); pass ``store`` to persist under a specific store instead, or
    an explicit memory-only ``ArtifactCache()`` to bypass persistence.
    """
    wl = _resolve(wl)
    if cache is None:
        cache = ArtifactCache(store=store) if store is not None else DEFAULT_CACHE
    dtype = dtype or wl.dtype
    if source not in ("auto", "analytic", "compiled"):
        raise ValueError(f"source must be auto|analytic|compiled, got {source!r}")
    if source == "auto":
        source = "analytic" if wl.has_analytic_model else "compiled"

    if source == "analytic":
        if not wl.has_analytic_model:
            raise ValueError(f"{wl.name}: no analytic model for source='analytic'")
        ev = events_from_analytic(
            flops=wl.flops,
            hbm_bytes=wl.hbm_bytes,
            gather_bytes=wl.gather_bytes,
            collective_bytes=wl.collective_bytes,
            n_devices=wl.n_devices,
        )
        ev.nonvec_flops = wl.flops * (1.0 - wl.vectorizable_fraction)
        report = wl.report(chip, dtype=dtype)
    else:
        ev = cache.events_for(wl)
        report = _report_from_events(wl.name, dtype, ev, chip)

    rl = adapted_roofline(chip, dtype)
    decision = classify(report, chip, roofline=rl)
    wall = _time_roi(wl, resolve_device(device)) if time_roi else None
    return SVEAnalysis(
        workload=wl.name,
        chip=chip.name,
        dtype=dtype,
        source=source,
        events=ev,
        report=report,
        roofline=rl,
        decision=decision,
        wall_s=wall,
        tuning=_tuning_outlook(wl, chip, dtype),
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


def analyze_compiled(
    name: str,
    recording: Recording,
    chip: hw.ChipSpec = hw.GRACE_CORE,
    *,
    dtype: str = "fp32",
    n_devices: int = 1,
) -> SVEAnalysis:
    """Analyze an already-taken :class:`~repro_torch.core.op_cost.Recording`
    (``op_cost.record(fn, args)``)."""
    ev = events_from_compiled(recording, n_devices=n_devices)
    return analyze_events(name, ev, chip, dtype=dtype)


def analyze_sweep(
    workloads: Optional[Iterable[WorkloadLike]] = None,
    chips: Sequence[hw.ChipSpec] = (hw.GRACE_CORE, hw.TPU_V5E),
    *,
    dtypes: Optional[Sequence[str]] = None,
    source: str = "auto",
    time_roi: bool = False,
    device: Union[str, torch.device] = "cuda",
    cache: Optional[ArtifactCache] = None,
    store: Union[ArtifactStore, str, None] = None,
    jobs: int = 1,
) -> List[SVEAnalysis]:
    """``analyze`` over a (workload x chip x dtype) grid, recording each
    workload at most once (events are chip-independent; see ArtifactCache).

    ``workloads`` defaults to every registered workload; ``dtypes`` defaults
    to each workload's own dtype.  Without an explicit ``cache``, the sweep
    is backed by the persistent default ArtifactStore (or ``store``), so a
    repeat sweep in a fresh process records nothing.

    ``jobs > 1`` fans the cells over a thread pool.  Results come back in
    the serial (workload, chip, dtype) order, and the cache's single-flight
    guarantee keeps the recording count at one per unique workload
    regardless of concurrency.
    """
    if cache is None:
        cache = ArtifactCache(store=store if store is not None else DEFAULT_STORE)
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
                       time_roi=time_roi, device=device, cache=cache)

    if jobs <= 1 or len(cells) <= 1:
        return [run_cell(c) for c in cells]
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        return list(pool.map(run_cell, cells))
