"""Analysis-as-a-service: the one-call SVE pipeline behind a request queue,
across from :mod:`repro.serve.analysis_service`.

Submit requests (workload x chips x dtypes), admit them in waves of up to
``max_batch``, drain until the queue is empty; ``jobs > 1`` fans each
wave's cells over a thread pool.  A cell that fails fails its request
only.  With ``time_roi`` each cell's ROI is timed on ``device``.  All
waves share one :class:`~repro_torch.analysis.pipeline.ArtifactCache`, by
default backed by the persistent
:class:`~repro_torch.analysis.store.ArtifactStore`, so:

* requests naming the same workload in one wave (or across waves) trigger
  a single recording (single-flight),
* a service restart re-serves previously analysed workloads with zero
  recordings (store hits; the report's ``compiles`` counts recordings).

The report's ``trajectory`` block is the perf ledger's state
(:mod:`repro_torch.perf`), and the CLI's ``--record`` appends the report
to that ledger and stamps the run id into it.  Its ``tuning`` block is
the autotuner's outlook of every kernel cell served
(:mod:`repro_torch.tuning`).

CLI (emits a JSON report; run it twice with the same ``--store-dir`` and
the second run records nothing):

    python -m repro_torch.serve.analysis_service --device cpu \\
        --workloads kernel/gemm kernel/spmv --chips grace-core h100 \\
        --source compiled --store-dir DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis.pipeline import (
    DEFAULT_STORE,
    ArtifactCache,
    SVEAnalysis,
    analyze,
    format_table,
)
from repro_torch.analysis.store import ArtifactStore
from repro_torch.analysis.workload import Workload, get_workload, list_workloads
from repro_torch.core import hw


@dataclasses.dataclass
class AnalysisRequest:
    """One queued unit of analysis: a workload swept over chips x dtypes."""

    uid: int
    workload: Union[str, Workload]
    chips: Tuple[str, ...] = ("grace-core",)
    dtypes: Optional[Tuple[str, ...]] = None
    source: str = "auto"
    time_roi: bool = False

    def __post_init__(self) -> None:
        self.results: List[SVEAnalysis] = []
        self.error: Optional[str] = None
        self.done = False

    @property
    def name(self) -> str:
        wl = self.workload
        return wl if isinstance(wl, str) else wl.name

    def cells(self) -> List[Tuple[Workload, hw.ChipSpec, str]]:
        wl = get_workload(self.workload) if isinstance(self.workload, str) else self.workload
        out = []
        for chip_name in self.chips:
            chip = hw.get_chip(chip_name)
            for dtype in self.dtypes or (wl.dtype,):
                out.append((wl, chip, dtype))
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "uid": self.uid,
            "workload": self.name,
            "chips": list(self.chips),
            "dtypes": list(self.dtypes) if self.dtypes else None,
            "source": self.source,
            "error": self.error,
            "results": [r.to_dict() for r in self.results],
        }


class AnalysisService:
    """Queue/wave engine serving SVE analyses against a shared store; ROIs
    are timed on ``device``."""

    def __init__(
        self,
        *,
        max_batch: int = 8,
        jobs: int = 1,
        device: str = "cuda",
        cache: Optional[ArtifactCache] = None,
        store: Union[ArtifactStore, str, None] = None,
    ) -> None:
        self.max_batch = max_batch
        self.jobs = max(int(jobs), 1)
        self.device = device
        self.cache = cache or ArtifactCache(
            store=store if store is not None else DEFAULT_STORE
        )
        self.queue: deque = deque()
        self.completed: Dict[int, AnalysisRequest] = {}
        self.waves = 0
        self.wall_s = 0.0
        self._next_uid = 0

    # -- submission -----------------------------------------------------------

    def submit(
        self,
        workload: Union[str, Workload, AnalysisRequest],
        *,
        chips: Sequence[str] = ("grace-core",),
        dtypes: Optional[Sequence[str]] = None,
        source: str = "auto",
        time_roi: bool = False,
    ) -> AnalysisRequest:
        """Enqueue one request; returns it (uid assigned here)."""
        if isinstance(workload, AnalysisRequest):
            req = workload
        else:
            req = AnalysisRequest(
                uid=-1,
                workload=workload,
                chips=tuple(chips),
                dtypes=tuple(dtypes) if dtypes else None,
                source=source,
                time_roi=time_roi,
            )
        req.uid = self._next_uid
        self._next_uid += 1
        self.queue.append(req)
        return req

    # -- one wave -------------------------------------------------------------

    def _run_wave(self, wave: List[AnalysisRequest]) -> None:
        """Batch the wave's requests into one fan-out against the shared
        cache: cells from different requests interleave freely; cells naming
        the same workload dedupe to one recording (single-flight)."""
        plan: List[Tuple[AnalysisRequest, Workload, hw.ChipSpec, str]] = []
        for req in wave:
            try:
                for wl, chip, dtype in req.cells():
                    plan.append((req, wl, chip, dtype))
            except Exception as e:  # noqa: BLE001 — unknown name, failing
                # lazy builder, bad shape math: fail THIS request only
                req.error = str(e)

        def run_cell(item):
            req, wl, chip, dtype = item
            # a cell that fails to record or analyze must not take the
            # drain (and every other in-flight request) down with it
            try:
                return analyze(wl, chip, dtype=dtype, source=req.source,
                               time_roi=req.time_roi, device=self.device,
                               cache=self.cache)
            except Exception as e:  # noqa: BLE001 — reported per request
                return e

        if self.jobs > 1 and len(plan) > 1:
            with ThreadPoolExecutor(max_workers=self.jobs) as pool:
                results = list(pool.map(run_cell, plan))
        else:
            results = [run_cell(item) for item in plan]
        for (req, _, chip, dtype), res in zip(plan, results):
            if isinstance(res, Exception):
                err = f"{req.name}@{chip.name}/{dtype}: {type(res).__name__}: {res}"
                req.error = req.error or err
            else:
                req.results.append(res)
        for req in wave:
            req.done = True
            self.completed[req.uid] = req

    # -- public ---------------------------------------------------------------

    def run_until_drained(self, max_waves: int = 1000) -> Dict[int, AnalysisRequest]:
        waves = 0
        t0 = time.perf_counter()
        while self.queue:
            wave = [
                self.queue.popleft()
                for _ in range(min(self.max_batch, len(self.queue)))
            ]
            self._run_wave(wave)
            self.waves += 1
            waves += 1
            if waves > max_waves:
                raise RuntimeError("analysis service loop did not drain")
        self.wall_s += time.perf_counter() - t0
        return self.completed

    def perf_ledger(self):
        """The perf ledger that corresponds to THIS service's store: the
        ``perf/`` sibling of its artifact directory (the default layout,
        ``$REPRO_ARTIFACT_DIR/torch/perf``), or the process default when
        the service runs store-less."""
        import os

        from repro_torch.perf import Ledger, default_ledger

        store = self.cache.store
        if store is None:
            return default_ledger()
        return Ledger(os.path.join(store.cache_dir, "perf"))

    def _trajectory(self) -> Dict[str, Any]:
        """Perf-ledger context for this report: how many trajectory points
        this service's ledger holds and the latest run id, so a consumer
        can line this report up against the recorded history.  Advisory —
        never raises (an empty/unreadable ledger reports zero runs)."""
        try:
            runs = self.perf_ledger().runs()
            return {
                "runs": len(runs),
                "latest_run_id": runs[-1].run_id if runs else None,
                "series": sorted({r.env.series_key() for r in runs}),
            }
        except Exception:  # noqa: BLE001 — trajectory context is advisory
            return {"runs": 0, "latest_run_id": None, "series": []}

    def report(self) -> Dict[str, Any]:
        """Machine-readable drain report; ``schema`` versions its shape.
        ``tuning`` summarizes the autotuner outlook of every kernel cell
        served: per (kernel, chip, dtype), the roofline-best launch
        variant, its predicted speedup over the kernel's default, and the
        persisted tuned config when the tuning store holds one.
        ``trajectory`` is the perf ledger's current state; the CLI's
        ``--record`` appends this very report to that ledger and stamps
        the resulting ``run_id`` into the payload."""
        reqs = [self.completed[uid].to_dict() for uid in sorted(self.completed)]
        n_cells = sum(len(r["results"]) for r in reqs)
        tuned: Dict[str, Any] = {}
        for uid in sorted(self.completed):
            for res in self.completed[uid].results:
                t = res.tuning
                if not t:
                    continue
                key = f"{t['kernel']}@{res.chip}/{res.dtype}"
                tuned[key] = {
                    "best_config": t["best_config"],
                    "predicted_speedup": t["predicted_speedup"],
                    "record": t["record"],
                }
        return {
            "kind": "analysis_service_report",
            "schema": 1,
            "requests": reqs,
            "tuning": tuned,
            "trajectory": self._trajectory(),
            "service": {
                "requests": len(reqs),
                "cells": n_cells,
                "waves": self.waves,
                "max_batch": self.max_batch,
                "jobs": self.jobs,
                "wall_s": self.wall_s,
                "compiles": self.cache.compiles,
                "cache_hits": self.cache.hits,
                "store_hits": self.cache.store_hits,
                "errors": sum(1 for r in reqs if r["error"]),
                "device": str(self.device),
            },
        }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def record(service: AnalysisService, report: Dict[str, Any],
           chips: Sequence[str]):
    """Append ``report`` to the service's perf ledger and stamp its
    ``run_id`` and the updated ``trajectory`` into it; returns the run, or
    None when every request errored.  The run's series must be what was
    served, or series-scoped gating never finds it: the chip is the first
    swept, the dtype the one the cells share, else ``"mixed"``."""
    from repro_torch.perf import capture_env

    if report["service"]["cells"] == 0:
        print("[perf ledger: nothing to record — every request errored]",
              file=sys.stderr)
        return None
    dtypes = {res["dtype"]
              for req in report["requests"] for res in req["results"]}
    ledger = service.perf_ledger()
    run = ledger.record_sources(
        analyses=report,
        env=capture_env(chip=chips[0],
                        dtype=dtypes.pop() if len(dtypes) == 1 else "mixed"),
        meta={"kind": "analysis_service"},
    )
    report["run_id"] = run.run_id
    report["trajectory"] = service._trajectory()  # now includes this run
    print(f"[perf ledger: recorded run {run.run_id[:12]} "
          f"(seq {run.seq}) -> {ledger.root}]", file=sys.stderr)
    return run


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.analysis_service",
        description="Serve a batch of SVE analyses; emit a JSON report.",
    )
    ap.add_argument("--workloads", nargs="+", default=None,
                    help="workload names (default: every registered workload)")
    ap.add_argument("--chips", nargs="+", default=["grace-core"],
                    choices=sorted(hw.CHIPS), help="chip models to sweep")
    ap.add_argument("--dtypes", nargs="+", default=None,
                    help="ELEN sweep (default: each workload's own dtype)")
    ap.add_argument("--source", default="auto",
                    choices=["auto", "analytic", "compiled"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="thread-pool width per wave")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="requests admitted per wave")
    ap.add_argument("--time-roi", action="store_true",
                    help="profiler-time each workload's ROI on --device")
    ap.add_argument("--device", default="cuda",
                    help="device the ROIs are timed on: cuda or cpu")
    ap.add_argument("--store-dir", default=None,
                    help="artifact store directory (default: "
                         "$REPRO_ARTIFACT_DIR/torch or "
                         "~/.cache/repro/artifacts/torch)")
    ap.add_argument("--no-store", action="store_true",
                    help="memory-only cache; never touch the disk store")
    ap.add_argument("--record", action="store_true",
                    help="append this report to the perf trajectory ledger "
                         "(repro_torch.perf) and stamp its run_id into the "
                         "payload")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list registered workloads and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in list_workloads():
            print(name)
        return 0

    if args.no_store:
        cache = ArtifactCache()
    else:
        cache = ArtifactCache(store=ArtifactStore(args.store_dir)
                              if args.store_dir else DEFAULT_STORE)
    service = AnalysisService(max_batch=args.max_batch, jobs=args.jobs,
                              device=args.device, cache=cache)
    known = set(list_workloads())
    names = args.workloads if args.workloads else sorted(known)
    unknown = [n for n in names if n not in known]
    if unknown:
        print(f"error: unknown workloads {unknown}; see --list", file=sys.stderr)
        return 2
    for name in names:
        service.submit(name, chips=args.chips, dtypes=args.dtypes,
                       source=args.source, time_roi=args.time_roi)
    service.run_until_drained()
    report = service.report()

    if args.record:
        record(service, report, args.chips)

    results = [r for req in service.completed.values() for r in req.results]
    print(format_table(results), file=sys.stderr)
    svc = report["service"]
    print(
        f"[{svc['requests']} requests / {svc['cells']} cells in "
        f"{svc['waves']} waves: {svc['compiles']} compiles, "
        f"{svc['store_hits']} store hits, {svc['wall_s']:.2f}s]",
        file=sys.stderr,
    )
    payload = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"report -> {args.out}", file=sys.stderr)
    else:
        print(payload)
    return 1 if svc["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
