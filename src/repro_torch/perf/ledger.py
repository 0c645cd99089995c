"""The perf-trajectory ledger: append-only, content-addressed BenchRuns (a
port of :mod:`repro.perf.ledger`).

Serve reports, scenario cells, analysis-service reports, benchmark
summaries and tuning reports become :class:`BenchRun` records persisted
through the port's :class:`~repro_torch.analysis.store.ArtifactStore`
(atomic temp-file + rename writes, corrupt entries skipped), under a
``perf/`` subdirectory of the artifact directory.

Records are **append-only**: every ``record()`` writes a *new* entry whose
run id is a content address over (environment, metrics, sequence number,
timestamp) — recording the same payload twice appends twice, and no write
ever rewrites an earlier run.  ``runs()`` returns the full history in
sequence order, and the regression gate (:mod:`repro_torch.perf.gate`)
compares any point against any baseline policy
(:mod:`repro_torch.perf.baseline`).

Each run is stamped with a :class:`RunEnv` fingerprint — chip, dtype, git
SHA, torch and CUDA versions, the card ``nvidia-smi`` names, active
tuned-config hash, host — and the trajectory is keyed by (chip, dtype)
series so those axes never get conflated.  Payloads are the reference's
(``{"kind": "perf_run", "perf_version": 1, "workload": ..., "run": ...}``)
and ``RunEnv.from_dict`` drops fields it does not know, so each package's
``Ledger`` reads a directory the other wrote.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import platform
import subprocess
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

from repro_torch.analysis.store import ArtifactStore, _default_dir, _store_for

PERF_VERSION = 1

#: Environment variable overriding the derived git SHA (containers/CI
#: sometimes run from an exported tree with no .git).
GIT_SHA_ENV = "REPRO_GIT_SHA"

#: The chip a serve run or scenario cell is recorded under: the card's
#: ChipSpec on CUDA, the reference's default model on the CPU, so card
#: runs and CPU runs never share a series.
CUDA_CHIP = "h100"
CPU_CHIP = "grace-core"


# ---------------------------------------------------------------------------
# Environment fingerprinting
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """Short git SHA of the working tree, ``$REPRO_GIT_SHA``, or "unknown"."""
    env = os.environ.get(GIT_SHA_ENV)
    if env:
        return env
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True,
            text=True,
            timeout=5,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


@functools.lru_cache(maxsize=1)
def gpu_name() -> str:
    """The first line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (the card's name and power limit), or "" where
    no card answers within 5 s."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=5,
        )
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            return lines[0].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return ""


def torch_version() -> str:
    try:
        import torch

        return torch.__version__
    except Exception:  # noqa: BLE001 — env stamp must never fail a run
        return "unknown"


def cuda_version() -> str:
    """The CUDA version torch was built for, "" for a CPU build."""
    try:
        import torch

        return torch.version.cuda or ""
    except Exception:  # noqa: BLE001 — env stamp must never fail a run
        return "unknown"


def tuned_state_hash() -> str:
    """Hash of every active tuned config across the kernel registry.

    This is the staleness signal the gate's triage keys on: a run recorded
    under one set of tuned configs and a run recorded under another are not
    the same experiment, even at the same git SHA.  Empty string when no
    kernel holds a tuned config (``repro_torch.tuning`` installs them;
    ``KernelOps.clear_tuned`` drops them).
    """
    try:
        from repro_torch.kernels.registry import KERNELS

        parts = []
        for name in sorted(KERNELS):
            ops = KERNELS[name]
            tuned = getattr(ops, "_tuned", None)
            if tuned:
                for key in sorted(tuned):
                    parts.append(f"{name}@{key}:{sorted(tuned[key].items())!r}")
        if not parts:
            return ""
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]
    except Exception:  # noqa: BLE001 — env stamp must never fail a run
        return ""


def device_chip(device: Any) -> str:
    """The chip name a run on ``device`` is recorded under."""
    return CUDA_CHIP if str(device).startswith("cuda") else CPU_CHIP


@dataclasses.dataclass(frozen=True)
class RunEnv:
    """Environment fingerprint one BenchRun was measured under."""

    chip: str = CPU_CHIP
    dtype: str = "fp32"
    git_sha: str = "unknown"
    torch_version: str = "unknown"
    cuda_version: str = ""
    gpu: str = ""
    tuned_hash: str = ""
    host: str = ""

    def series_key(self) -> str:
        """The trajectory axis: runs compare within one (chip, dtype)."""
        return f"{self.chip}/{self.dtype}"

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunEnv":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: str(v) for k, v in d.items() if k in fields})


def capture_env(chip: str = CPU_CHIP, dtype: str = "fp32") -> RunEnv:
    """Stamp the current process: git SHA, torch/CUDA versions, the card,
    tuned configs, host."""
    return RunEnv(
        chip=chip,
        dtype=dtype,
        git_sha=git_sha(),
        torch_version=torch_version(),
        cuda_version=cuda_version(),
        gpu=gpu_name(),
        tuned_hash=tuned_state_hash(),
        host=platform.node(),
    )


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BenchRun:
    """One appended trajectory point: env + per-workload metric dicts.

    ``metrics`` maps a workload key (``kernel/gemm@h100/fp32``,
    ``serve/gpt2-124m@continuous``, ``scenario/<cell_id>``) to a flat dict
    of named quantities (``wall_s``, ``ai``, ``r_ins``, ``perf_class``,
    ``fused_steps``, ...).  Everything the triage needs to re-run the
    paper's decision tree on a historical point is stored here — a
    BenchRun is self-contained.
    """

    run_id: str
    seq: int
    timestamp: float
    env: RunEnv
    metrics: Dict[str, Dict[str, Any]]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "run_id": self.run_id,
            "seq": self.seq,
            "timestamp": self.timestamp,
            "env": self.env.to_dict(),
            "metrics": self.metrics,
            "meta": self.meta,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "BenchRun":
        return cls(
            run_id=str(d["run_id"]),
            seq=int(d["seq"]),
            timestamp=float(d.get("timestamp", 0.0)),
            env=RunEnv.from_dict(d.get("env") or {}),
            metrics={
                str(k): dict(v) for k, v in (d.get("metrics") or {}).items()
            },
            meta=dict(d.get("meta") or {}),
        )

    def metric(self, key: str, name: str, default: Any = None) -> Any:
        return (self.metrics.get(key) or {}).get(name, default)


def run_id_for(
    env: RunEnv, metrics: Mapping[str, Mapping[str, Any]], seq: int, ts: float
) -> str:
    """Content address of one trajectory point.

    Sequence number and timestamp are part of the address on purpose: two
    identical measurements made at different times are two distinct
    points, and appending can never silently rewrite history.
    """
    payload = json.dumps(
        {"env": env.to_dict(), "metrics": metrics, "seq": seq, "ts": ts},
        sort_keys=True,
        default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


# ---------------------------------------------------------------------------
# Metric extraction: summary / tuning / analysis / serving / scenario reports
# ---------------------------------------------------------------------------


def metrics_from_summary(summary: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-benchmark rows / wall time / pass-fail from ``summary.json``."""
    out: Dict[str, Dict[str, Any]] = {}
    for bench in summary.get("benchmarks") or []:
        name = bench.get("name", "?")
        out[f"bench/{name}"] = {
            "ok": bool(bench.get("ok")),
            "rows": int(bench.get("rows", 0)),
            "wall_s": float(bench.get("wall_s", 0.0)),
        }
    return out


def _config_token(config: Any) -> str:
    """Order-stable string form of a tuned config dict."""
    if isinstance(config, Mapping):
        return " ".join(f"{k}={v}" for k, v in sorted(config.items()))
    return str(config)


def metrics_from_tuning(report: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-(kernel, chip, dtype) timings and configs from ``tuning.json``."""
    out: Dict[str, Dict[str, Any]] = {}
    for rec in report.get("records") or []:
        key = f"tuning/{rec['kernel']}@{rec['chip']}/{rec['dtype']}"
        out[key] = {
            "best_time_s": float(rec.get("best_time_s", 0.0)),
            "default_time_s": float(rec.get("default_time_s", 0.0)),
            "speedup_vs_default": float(rec.get("speedup_vs_default", 1.0)),
            "predicted_speedup": float(rec.get("predicted_speedup", 1.0)),
            "config": _config_token(rec.get("config") or {}),
        }
    return out


def _metrics_from_analysis_dict(d: Mapping[str, Any]) -> Dict[str, Any]:
    """Flatten one SVEAnalysis dict into the ledger's metric schema.

    Keeps every quantity the Fig. 8 decision tree and Eq. 2 roofline need,
    so :mod:`repro_torch.perf.triage` can re-classify a historical point
    without the original events.
    """
    hbm = float(d.get("hbm_bytes") or 0.0)
    m: Dict[str, Any] = {
        "ai": float(d.get("ai") or 0.0),
        "r_ins": float(d.get("r_ins") or 0.0),
        "flops": float(d.get("flops") or 0.0),
        "hbm_bytes": hbm,
        "gather_bytes": float(d.get("gather_fraction") or 0.0) * hbm,
        "vectorizable_fraction": float(d.get("vectorizable_fraction") or 0.0),
        "perf_class": int(d.get("perf_class") or 0),
        "predicted_speedup": float(d.get("predicted_speedup") or 1.0),
    }
    if d.get("wall_s") is not None:
        m["wall_s"] = float(d["wall_s"])
    tuning = d.get("tuning") or {}
    if tuning.get("record"):
        m["config"] = _config_token(tuning["record"])
    return m


#: Serving-report quantities the ledger tracks (see
#: :meth:`repro_torch.serve.engine.ServeEngine.stats`).  Slot utilization
#: is the Eq. 1 lane-utilization analogue at the serving layer;
#: fused_steps and the slot-step counters are deterministic given the
#: request trace, so the gate holds them as tightly as the analytic
#: counters.  ``wall_s`` is deliberately NOT ingested: the shared spec
#: table would gate it at the benchmark tolerance (10%), tighter than the
#: serving timing specs (tok_s 15%, p95 20%) — it would always trip first
#: and make them dead letters.
_SERVING_METRICS = (
    "requests", "new_tokens", "fused_steps", "busy_slot_steps",
    "slot_steps", "slot_utilization", "tok_s",
    "p50_latency_s", "p95_latency_s", "ttft_p50_s", "ttft_p95_s",
    "ttft_p50_steps", "ttft_p95_steps",
    "preemptions", "rejected", "restarts", "prefill_chunk",
    # block-pool dedup (prefix sharing + quantized paging): deterministic
    # given the trace, so the gate holds the counters exactly and the
    # dedup ratio — the memory-side Eq. 1 analogue — like slot_utilization
    "logical_blocks", "physical_blocks", "shared_block_hits",
    "cow_copies", "kv_bytes_served", "kv_bytes_stored",
    "block_dedup_ratio",
    # speculative decoding: exact counters (deterministic given the
    # trace, held at tol 0) plus acceptance_rate — the Eq. 1 active-lane
    # fraction of each k-wide verification issue
    "spec_k", "drafted_tokens", "accepted_tokens", "rejected_tokens",
    "draft_steps", "target_steps", "acceptance_rate",
    # tensor-parallel serving: device count is placement config, and
    # device_lane_utilization (worst device shard's busy-lane fraction,
    # Eq. 1 one level up) is pure slot accounting — both exact
    "mesh_devices", "device_lane_utilization",
)

#: _SERVING_METRICS names that are exact counters (held tight by the gate);
#: the rest are wall-derived floats with noisy tolerances.
_SERVING_INT_METRICS = frozenset((
    "requests", "new_tokens", "fused_steps", "busy_slot_steps",
    "slot_steps", "preemptions", "rejected", "restarts", "prefill_chunk",
    "logical_blocks", "physical_blocks", "shared_block_hits",
    "cow_copies", "kv_bytes_served", "kv_bytes_stored",
    "spec_k", "drafted_tokens", "accepted_tokens", "rejected_tokens",
    "draft_steps", "target_steps", "mesh_devices",
))


def _serving_row(stats: Mapping[str, Any]) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    for name in _SERVING_METRICS:
        if stats.get(name) is not None:
            row[name] = (int(stats[name]) if name in _SERVING_INT_METRICS
                         else float(stats[name]))
    return row


def metrics_from_serving(report: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """One metric row per serve run from a ``serve_report`` payload
    (:func:`repro_torch.launch.serve.build_report`), keyed
    ``serve/<arch>@<scheduler>`` so wave and continuous trajectories never
    get conflated.  Chunked-prefill runs (``prefill_chunk > 1``) append a
    ``+prefill<C>`` segment; the same reasoning forks ``+kv<dtype>`` for
    quantized KV pools, ``+shared`` for prefix-sharing runs, ``+spec<k>``
    for speculative decoding (``+adapt`` for its adaptive width) and
    ``+mesh<DxM>`` for a mesh placement: each is a different experiment,
    never gated against another's baseline."""
    stats = report.get("stats") or {}
    chunk = int(report.get("prefill_chunk",
                           stats.get("prefill_chunk", 1)) or 1)
    key = (f"serve/{report.get('arch', '?')}"
           f"@{report.get('scheduler', stats.get('scheduler', '?'))}")
    if chunk > 1:
        key += f"+prefill{chunk}"
    kv_dtype = str(report.get("kv_dtype",
                              stats.get("kv_dtype", "f32")) or "f32")
    if kv_dtype != "f32":
        key += f"+kv{kv_dtype}"
    if report.get("share_prefixes", stats.get("share_prefixes")):
        key += "+shared"
    spec_k = int(report.get("spec_k", stats.get("spec_k", 0)) or 0)
    if spec_k > 0:
        key += f"+spec{spec_k}"
        # adaptive width is a different drafted/accepted trajectory by
        # design — never gate it against fixed-width
        if report.get("spec_adaptive", stats.get("spec_adaptive")):
            key += "+adapt"
    # mesh placement forks the trajectory too: fused-step counters are
    # identical across shapes (the golden contract), but wall metrics and
    # device_lane_utilization are per-shape quantities
    mesh = report.get("mesh", stats.get("mesh"))
    if mesh:
        key += f"+mesh{mesh}"
    row = _serving_row(stats)
    # submit-time rejections live on the report, not in engine stats: the
    # engine never saw those requests (launch.serve counts them)
    if "rejected" not in row and report.get("rejected") is not None:
        row["rejected"] = int(report["rejected"])
    return {key: row} if row else {}


def metrics_from_scenario(report: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """One metric row per scenario cell from a ``scenario_cell`` payload
    (:meth:`repro_torch.scenarios.runner.CellResult.report`), keyed by the
    cell's ``scenario/<cell_id>`` ledger key so the gate compares each
    cell only against its own trajectory.  ``golden_ok`` / ``slo_ok``
    ride along as booleans: the gate regresses any True -> False flip."""
    stats = report.get("stats") or {}
    key = str(report.get("ledger_key")
              or f"scenario/{report.get('cell_id', '?')}")
    row = _serving_row(stats)
    if not row:
        return {}
    row["rejected"] = int(len(report.get("rejected") or ())
                          if "rejected" not in row else row["rejected"])
    row["restarts"] = int(report.get("restarts", row.get("restarts", 0)))
    if report.get("golden_checked"):
        row["golden_ok"] = bool(report.get("golden_ok"))
    row["slo_ok"] = not report.get("slo_failures")
    return {key: row}


def metrics_from_analysis(
    analyses: Union[Mapping[str, Any], Iterable[Any]],
) -> Dict[str, Dict[str, Any]]:
    """Metric dicts from SVEAnalysis objects, their dicts, or a whole
    analysis-service report (``requests[].results[]`` are walked)."""
    if isinstance(analyses, Mapping):
        cells: List[Mapping[str, Any]] = []
        for req in analyses.get("requests") or []:
            cells.extend(req.get("results") or [])
    else:
        cells = [a.to_dict() if hasattr(a, "to_dict") else a for a in analyses]
    out: Dict[str, Dict[str, Any]] = {}
    for d in cells:
        key = f"{d['workload']}@{d['chip']}/{d['dtype']}"
        out[key] = _metrics_from_analysis_dict(d)
    return out


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------


def default_perf_dir() -> str:
    """``<the port's artifact dir>/perf`` — rides ``$REPRO_ARTIFACT_DIR``
    so test isolation and operator overrides cover the ledger for free."""
    return os.path.join(_default_dir(), "perf")


class Ledger:
    """Append-only trajectory of BenchRuns over one store directory.

    Reads (``runs`` / ``get`` / ``latest`` / ``next_seq``) re-enumerate the
    directory each call — correctness under concurrent recorders is worth
    more than caching at trajectory scale (hundreds of small JSON files);
    callers looping over history should take one ``runs()`` snapshot.
    """

    def __init__(self, root: Optional[str] = None) -> None:
        self.root = root or default_perf_dir()
        self.store: ArtifactStore = _store_for(self.root)

    # -- write ---------------------------------------------------------------

    def record(
        self,
        metrics: Mapping[str, Mapping[str, Any]],
        *,
        env: Optional[RunEnv] = None,
        meta: Optional[Mapping[str, Any]] = None,
    ) -> BenchRun:
        """Append one trajectory point; returns the persisted BenchRun.

        Never rewrites: the run id covers the sequence number and
        timestamp, so even a byte-identical metric payload lands in a new
        entry.  Concurrent recorders may race to the same ``seq``; both
        entries survive (distinct ids) and sorting breaks ties by
        timestamp then id.
        """
        if not metrics:
            raise ValueError("refusing to record an empty metric set")
        env = env or capture_env()
        seq = self.next_seq()
        ts = time.time()
        metrics = {str(k): dict(v) for k, v in metrics.items()}
        run = BenchRun(
            run_id=run_id_for(env, metrics, seq, ts),
            seq=seq,
            timestamp=ts,
            env=env,
            metrics=metrics,
            meta=dict(meta or {}),
        )
        self.store.put_json(
            run.run_id,
            {
                "kind": "perf_run",
                "perf_version": PERF_VERSION,
                "workload": f"perf/{env.series_key()}#{seq}",
                "run": run.to_dict(),
            },
        )
        return run

    def record_sources(
        self,
        *,
        summary: Optional[Mapping[str, Any]] = None,
        tuning: Optional[Mapping[str, Any]] = None,
        analyses: Union[Mapping[str, Any], Iterable[Any], None] = None,
        serving: Optional[Mapping[str, Any]] = None,
        env: Optional[RunEnv] = None,
        meta: Optional[Mapping[str, Any]] = None,
    ) -> BenchRun:
        """Ingest any mix of the stack's artifacts into one BenchRun."""
        metrics: Dict[str, Dict[str, Any]] = {}
        sources: List[str] = []
        if summary is not None:
            metrics.update(metrics_from_summary(summary))
            sources.append("summary")
        if tuning is not None:
            metrics.update(metrics_from_tuning(tuning))
            sources.append("tuning")
        if analyses is not None:
            metrics.update(metrics_from_analysis(analyses))
            sources.append("analysis")
        if serving is not None:
            metrics.update(metrics_from_serving(serving))
            sources.append("serving")
        if env is None and summary is not None and summary.get("env"):
            env = RunEnv.from_dict(summary["env"])
        meta = {**(meta or {}), "sources": sources}
        # an aborted benchmark run must carry its failure count no matter
        # which ingestion path recorded it: baseline resolution filters on
        # meta["failed"] so truncated wall times never anchor a gate
        if summary is not None and summary.get("failed"):
            meta.setdefault("failed", int(summary["failed"]))
        return self.record(metrics, env=env, meta=meta)

    # -- read ----------------------------------------------------------------

    def runs(self, series: Optional[str] = None) -> List[BenchRun]:
        """Every readable run, sequence-ordered; optionally one series."""
        out: List[BenchRun] = []
        for _, payload in self.store.iter_json():
            if payload.get("perf_version") != PERF_VERSION:
                continue
            try:
                run = BenchRun.from_dict(payload["run"])
            except (KeyError, TypeError, ValueError):
                continue  # corrupt-skip: never raise out of enumeration
            if series is None or run.env.series_key() == series:
                out.append(run)
        out.sort(key=lambda r: (r.seq, r.timestamp, r.run_id))
        return out

    def get(self, run_id: str) -> Optional[BenchRun]:
        """Exact or unique-prefix lookup by run id."""
        matches = [r for r in self.runs() if r.run_id.startswith(run_id)]
        return matches[0] if len(matches) == 1 else None

    def latest(self, series: Optional[str] = None) -> Optional[BenchRun]:
        runs = self.runs(series)
        return runs[-1] if runs else None

    def next_seq(self) -> int:
        runs = self.runs()
        return (runs[-1].seq + 1) if runs else 1

    def series(self) -> List[str]:
        return sorted({r.env.series_key() for r in self.runs()})

    def __repr__(self) -> str:
        # no runs() here: repr must not do directory I/O (debugger/logging)
        return f"Ledger({self.root!r})"


def default_ledger() -> Ledger:
    """Ledger over the default directory, resolved at call time (so the
    ``$REPRO_ARTIFACT_DIR`` override is honored, mirroring default_store)."""
    return Ledger(default_perf_dir())
