"""Analysis-as-a-service: the one-call SVE pipeline behind a request queue,
across from :mod:`repro.serve.analysis_service`.

Submit requests (workload x chips x dtypes), admit them in waves of up to
``max_batch``, drain until the queue is empty; ``jobs > 1`` fans each
wave's cells over a thread pool.  A cell that fails fails its request
only.  With ``time_roi`` each cell's ROI is timed on ``device``.

The report's ``trajectory`` block is the perf ledger's state
(:mod:`repro_torch.perf`), and the CLI's ``--record`` appends the report
to that ledger and stamps the run id into it.  The reference's artifact
cache and store and its tuning outlook are not ported yet: the CLI's
``--store-dir`` and ``--no-store`` name ROADMAP 1.17, and the report
carries no ``tuning`` block and no compile counts.

CLI (emits a JSON report):

    python -m repro_torch.serve.analysis_service --device cpu \\
        --workloads kernel/gemm kernel/spmv --chips grace-core h100
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

from repro_torch.analysis.pipeline import SVEAnalysis, analyze, format_table
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
    """Queue/wave engine serving SVE analyses; ROIs are timed on
    ``device``."""

    def __init__(self, *, max_batch: int = 8, jobs: int = 1,
                 device: str = "cuda") -> None:
        self.max_batch = max_batch
        self.jobs = max(int(jobs), 1)
        self.device = device
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
        """Batch the wave's requests into one fan-out: cells from different
        requests interleave freely."""
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
            # a cell that fails to analyze must not take the drain (and
            # every other in-flight request) down with it
            try:
                return analyze(wl, chip, dtype=dtype, source=req.source,
                               time_roi=req.time_roi, device=self.device)
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
        """The perf ledger this service's reports belong to: the process
        default (``$REPRO_ARTIFACT_DIR/torch/perf``) while the service has
        no artifact store of its own (ROADMAP 1.17)."""
        from repro_torch.perf import default_ledger

        return default_ledger()

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
        ``trajectory`` is the perf ledger's current state; the CLI's
        ``--record`` appends this very report to that ledger and stamps
        the resulting ``run_id`` into the payload."""
        reqs = [self.completed[uid].to_dict() for uid in sorted(self.completed)]
        n_cells = sum(len(r["results"]) for r in reqs)
        return {
            "kind": "analysis_service_report",
            "schema": 1,
            "requests": reqs,
            "trajectory": self._trajectory(),
            "service": {
                "requests": len(reqs),
                "cells": n_cells,
                "waves": self.waves,
                "max_batch": self.max_batch,
                "jobs": self.jobs,
                "wall_s": self.wall_s,
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
                    help="not ported yet (ROADMAP 1.17)")
    ap.add_argument("--no-store", action="store_true",
                    help="not ported yet (ROADMAP 1.17)")
    ap.add_argument("--record", action="store_true",
                    help="append this report to the perf trajectory ledger "
                         "(repro_torch.perf) and stamp its run_id into the "
                         "payload")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list registered workloads and exit")
    args = ap.parse_args(argv)

    if args.store_dir is not None or args.no_store:
        ap.error("not ported yet: the artifact store is ROADMAP item 1.17")
    if args.list:
        for name in list_workloads():
            print(name)
        return 0

    service = AnalysisService(max_batch=args.max_batch, jobs=args.jobs,
                              device=args.device)
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
        f"{svc['waves']} waves, {svc['wall_s']:.2f}s]",
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
