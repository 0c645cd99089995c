"""Cell execution: drive the port's ServeEngine per scenario, diff golden
twins, check SLOs.

Port of ``repro/scenarios/runner.py``.  Execution paths:

* **engine path** (``none``/``preempt``/``malformed``): one
  :class:`~repro_torch.serve.engine.ServeEngine` per cell, traffic
  delivered by a :class:`TrafficFeeder` step hook honoring sampled arrival
  steps, the fault plan's hook (if any) riding alongside.
* **resilient path** (``device-loss``): the trace is partitioned into
  chunks and served under
  :class:`~repro_torch.distributed.fault_tolerance.ResilientLoop` — every
  chunk commits its served tokens into a fixed-shape state checkpointed
  through :class:`~repro_torch.checkpoint.CheckpointStore`; the injected
  :class:`~repro_torch.scenarios.faults.SimulatedDeviceLoss` kills the
  drain mid-chunk, the loop restores the newest committed checkpoint, and
  the replayed chunk must (and does) regenerate identical tokens.

Every faulted cell is diffed against its fault-free **golden twin** (same
seed, same traffic — the fault axis is excluded from seed derivation):
served token streams must match uid-for-uid, token-for-token.  A twin
mismatch, an SLO violation, or a cell error all fail the cell; the gate
CLI turns failed cells into a non-zero exit.

Cells run on ``device`` ("cuda" unless the caller asks for the CPU), with
one set of parameters an architecture and device (:data:`_PARAMS`: the
port's ``init_lm(get_smoke_config(arch), seed=0)`` unless a caller filled
it first).  A meshed cell runs whole inside
:func:`repro_torch.launch.mesh.spawn`: its parameters go to the ranks,
each rank cuts its shards and runs the feeder, the fault hook and, for
``device-loss``, the whole resilient loop over a checkpoint directory of
its own.  The hooks read only the engine's step counter and host state,
which every rank shares, so every rank fails and restores at the same
step; rank 0 returns the tokens and stats.  :func:`record_cell` (and
``run_matrix(record=True)``) appends a cell to the perf ledger
(:mod:`repro_torch.perf`), keyed ``scenario/<cell_id>``.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import shutil
import tempfile
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import metrics as core_metrics
from repro_torch.core.device import resolve_device
from repro_torch.distributed.fault_tolerance import (FaultToleranceConfig,
                                                     ResilientLoop)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.scenarios import faults as faults_mod
from repro_torch.scenarios.matrix import MatrixSpec, Scenario
from repro_torch.scenarios.traffic import RequestSpec, sample_trace
from repro_torch.serve.engine import Request, RequestTooLong, ServeEngine

# one model per (architecture, device), shared across every cell (and
# thread): (arch, str(resolved device)) -> (cfg, params)
_PARAMS_LOCK = threading.Lock()
_PARAMS: Dict[Tuple[str, str], Tuple[Any, Any]] = {}

#: draft model every speculating cell uses; cells targeting this same
#: arch self-speculate (acceptance 1.0 on the CPU), other archs exercise
#: the rejection/rewind path
DRAFT_ARCH = "gpt2-124m"

#: seconds a meshed execution may take, its ranks' collectives included
MESH_TIMEOUT_S = 120.0


def _params_for(arch: str, device) -> Tuple[Any, Any]:
    dev = resolve_device(device)
    with _PARAMS_LOCK:
        key = (arch, str(dev))
        if key not in _PARAMS:
            cfg = configs.get_smoke_config(arch)
            _PARAMS[key] = (cfg, transformer.init_lm(cfg, seed=0,
                                                     device=dev))
        return _PARAMS[key]


@dataclasses.dataclass
class _Serving:
    """What every engine of one execution is built from: the target, the
    draft of a speculating cell, and the device or this rank's mesh."""

    cfg: Any
    params: Any
    draft: Optional[Tuple[Any, Any]]
    device: Any
    mesh: Any = None

    def engine(self, cell: Scenario) -> ServeEngine:
        spec = {}
        if cell.spec_k > 0:
            draft_cfg, draft_params = self.draft
            spec = {"spec_k": cell.spec_k, "draft_cfg": draft_cfg,
                    "draft_params": draft_params}
        return ServeEngine(
            self.cfg, self.params, max_batch=cell.max_batch,
            max_len=cell.max_len, scheduler=cell.scheduler,
            block_size=cell.block_size, prefill_chunk=cell.prefill_chunk,
            prefill_budget=cell.prefill_budget,
            share_prefixes=cell.share_prefixes, mesh=self.mesh,
            device=self.device, **spec,
        )


class TrafficFeeder:
    """Step hook delivering the sampled trace on the engine's step clock.

    ``clock = engine.steps + offset``: when the engine goes fully idle
    before the next arrival, the feeder fast-forwards ``offset`` to it
    (compressing dead air instead of spinning), which keeps arrival
    *patterns* — bursts, gaps, overlaps — while staying deterministic.
    Malformed submissions are caught typed and counted, never raised.
    """

    def __init__(self, trace: List[RequestSpec]):
        self.pending = deque(sorted(trace,
                                    key=lambda r: (r.arrive_step, r.uid)))
        self.offset = 0
        self.submitted = 0
        self.rejected: List[Tuple[int, str]] = []

    def _deliver(self, engine: ServeEngine) -> int:
        n = 0
        while (self.pending
               and self.pending[0].arrive_step <= engine.steps + self.offset):
            spec = self.pending.popleft()
            try:
                engine.submit(Request(
                    uid=spec.uid, prompt=np.array(spec.prompt, np.int32),
                    max_new_tokens=spec.max_new_tokens, eos_id=spec.eos_id,
                ))
                self.submitted += 1
            except (RequestTooLong, ValueError) as e:
                self.rejected.append((spec.uid, str(e)))
            n += 1
        return n

    def __call__(self, engine: ServeEngine, busy: bool) -> bool:
        delivered = self._deliver(engine)
        if (self.pending and not delivered and not busy and not engine.queue):
            # fully idle with future arrivals: jump the clock to the next one
            self.offset = max(
                self.offset, self.pending[0].arrive_step - engine.steps
            )
            self._deliver(engine)
        return bool(self.pending)


# ---------------------------------------------------------------------------
# Execution paths
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Execution:
    """Raw outcome of serving one trace (either path)."""

    stats: Dict[str, Any]
    tokens: Dict[int, List[int]]
    rejected: List[Tuple[int, str]]
    restarts: int = 0


def _execute_engine(cell: Scenario, serving: _Serving,
                    trace: List[RequestSpec],
                    fault_hook=None) -> _Execution:
    engine = serving.engine(cell)
    feeder = TrafficFeeder(trace)
    engine.add_step_hook(feeder)
    if fault_hook is not None:
        engine.add_step_hook(fault_hook)
    engine.run_until_drained()
    stats = engine.stats()
    stats["rejected"] = len(feeder.rejected)
    stats["restarts"] = 0
    return _Execution(
        stats=stats,
        tokens={uid: list(r.generated) for uid, r in engine.completed.items()},
        rejected=feeder.rejected,
    )


def _percentile(vals: List[float], q: float) -> float:
    return float(np.percentile(vals, q)) if vals else 0.0


def _execute_resilient(cell: Scenario, serving: _Serving,
                       trace: List[RequestSpec],
                       plan: Optional[faults_mod.DeviceLossPlan]
                       ) -> _Execution:
    """Chunked serving under ResilientLoop + CheckpointStore.

    The trace is split into ``max_batch``-request chunks (arrival order);
    each chunk is one resilient *step*: serve it on a fresh engine, merge
    its tokens into the fixed-shape state, checkpoint.  A crash mid-chunk
    loses only the uncommitted chunk, and the replay regenerates it
    bit-identically (greedy decode over a seeded trace).  The crashed
    engine, its cache and its block pool are referenced only by the
    exception's frames, which the loop drops before the replay: the
    replayed chunk's engine starts from nothing the crashed one left.
    """
    chunks = [trace[i:i + cell.max_batch]
              for i in range(0, len(trace), cell.max_batch)]
    uid_row = {spec.uid: i for i, spec in enumerate(trace)}
    R = len(trace)
    crash = plan.make_crash_hook() if plan is not None else None
    fail_chunk = (min(plan.fail_chunk, len(chunks) - 1)
                  if plan is not None else -1)
    # host-side per-chunk observations, overwritten on replay so the
    # retried chunk counts exactly once in the aggregate
    chunk_obs: Dict[int, Dict[str, Any]] = {}
    rejected: Dict[int, List[Tuple[int, str]]] = {}

    def make_state():
        return {
            "tokens": np.full((R, cell.max_new), -1, np.int32),
            "served": np.zeros((R,), np.int32),
        }

    def step_fn(chunk_idx: int, state):
        sub = chunks[chunk_idx]
        base = min(s.arrive_step for s in sub)
        rebased = [dataclasses.replace(s, arrive_step=s.arrive_step - base)
                   for s in sub]
        engine = serving.engine(cell)
        feeder = TrafficFeeder(rebased)
        engine.add_step_hook(feeder)
        if crash is not None and chunk_idx == fail_chunk:
            engine.add_step_hook(crash)
        engine.run_until_drained()
        tokens = np.array(state["tokens"])
        served = np.array(state["served"])
        lats, ttfts, ttft_steps = [], [], []
        for uid, r in engine.completed.items():
            row = uid_row[uid]
            tokens[row, : len(r.generated)] = r.generated
            served[row] = len(r.generated)
            if r.latency_s is not None:
                lats.append(r.latency_s)
            if r.ttft_s is not None:
                ttfts.append(r.ttft_s)
            if r.ttft_steps is not None:
                ttft_steps.append(r.ttft_steps)
        chunk_obs[chunk_idx] = {"stats": engine.stats(), "lats": lats,
                                "ttfts": ttfts, "ttft_steps": ttft_steps}
        rejected[chunk_idx] = feeder.rejected
        return {"tokens": tokens, "served": served}

    ckpt_dir = tempfile.mkdtemp(prefix="scenario-ckpt-")
    try:
        loop = ResilientLoop(
            CheckpointStore(ckpt_dir),
            FaultToleranceConfig(checkpoint_every=1, async_save=False,
                                 max_restarts=4),
            step_fn, make_state,
        )
        out = loop.run(total_steps=len(chunks))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    tokens_arr = np.asarray(out["state"]["tokens"])
    served = np.asarray(out["state"]["served"])
    tokens = {
        spec.uid: tokens_arr[uid_row[spec.uid],
                             : int(served[uid_row[spec.uid]])].tolist()
        for spec in trace if int(served[uid_row[spec.uid]]) > 0
    }
    # aggregate the per-chunk engines into one cell-level stats row
    obs = [chunk_obs[i] for i in sorted(chunk_obs)]
    totals = {k: sum(o["stats"][k] for o in obs) for k in (
        "requests", "new_tokens", "fused_steps", "busy_slot_steps",
        "slot_steps", "preemptions", "wall_s",
        "logical_blocks", "physical_blocks", "shared_block_hits",
        "cow_copies", "kv_bytes_served", "kv_bytes_stored",
        "drafted_tokens", "accepted_tokens", "rejected_tokens",
        "draft_steps", "target_steps")}
    lats = [v for o in obs for v in o["lats"]]
    ttfts = [v for o in obs for v in o["ttfts"]]
    ttft_steps = [float(v) for o in obs for v in o["ttft_steps"]]
    rej = [r for i in sorted(rejected) for r in rejected[i]]

    stats = {
        "scheduler": cell.scheduler,
        "prefill_chunk": cell.prefill_chunk,
        "share_prefixes": cell.share_prefixes,
        "spec_k": cell.spec_k,
        "mesh": cell.mesh,
        "mesh_devices": max(
            (int(o["stats"].get("mesh_devices", 1)) for o in obs), default=1),
        # the min over chunk engines: the cell's worst device-lane
        # utilization across the whole (possibly restarted) run
        "device_lane_utilization": min(
            (float(o["stats"].get("device_lane_utilization", 0.0))
             for o in obs), default=0.0),
        **{k: totals[k] for k in ("requests", "new_tokens", "fused_steps",
                                  "busy_slot_steps", "slot_steps",
                                  "preemptions", "logical_blocks",
                                  "physical_blocks", "shared_block_hits",
                                  "cow_copies", "kv_bytes_served",
                                  "kv_bytes_stored", "drafted_tokens",
                                  "accepted_tokens", "rejected_tokens",
                                  "draft_steps", "target_steps")},
        "acceptance_rate": core_metrics.acceptance_rate(
            totals["accepted_tokens"], totals["drafted_tokens"]),
        # block-granular fallback for pure-SSM archs (zero paged KV bytes)
        "block_dedup_ratio": core_metrics.block_dedup_ratio(
            totals["kv_bytes_served"], totals["kv_bytes_stored"]
        ) if totals["kv_bytes_stored"] > 0 else
        core_metrics.block_dedup_ratio(
            totals["logical_blocks"], totals["physical_blocks"]),
        "slot_utilization": (totals["busy_slot_steps"] / totals["slot_steps"]
                             if totals["slot_steps"] else 0.0),
        "wall_s": totals["wall_s"],
        "tok_s": (totals["new_tokens"] / totals["wall_s"]
                  if totals["wall_s"] > 0 else 0.0),
        "p50_latency_s": _percentile(lats, 50),
        "p95_latency_s": _percentile(lats, 95),
        "ttft_p50_s": _percentile(ttfts, 50),
        "ttft_p95_s": _percentile(ttfts, 95),
        "ttft_p50_steps": _percentile(ttft_steps, 50),
        "ttft_p95_steps": _percentile(ttft_steps, 95),
        "rejected": len(rej),
        "restarts": int(out["restarts"]),
    }
    return _Execution(stats=stats, tokens=tokens, rejected=rej,
                      restarts=int(out["restarts"]))


def _serve_trace(cell: Scenario, inject: bool,
                 serving: _Serving) -> _Execution:
    trace = sample_trace(cell, serving.cfg.vocab)
    plan = faults_mod.get_plan(cell.fault)
    if inject:
        trace = plan.mutate_trace(trace, cell)
    if plan.resilient:
        return _execute_resilient(cell, serving, trace,
                                  plan if inject else None)
    hook = plan.make_hook(cell) if inject else None
    return _execute_engine(cell, serving, trace, fault_hook=hook)


def _serve_on_rank(mesh, cell: Scenario, inject: bool, cfg, params,
                   draft) -> _Execution:
    """One rank's part of a meshed execution: its shards of the full
    parameters (and of the draft's), then the whole execution."""
    def shard(p):
        return transformer.shard_params(p, mesh, mesh.device)

    serving = _Serving(cfg, shard(params),
                       None if draft is None else (draft[0], shard(draft[1])),
                       mesh.device, mesh)
    return _serve_trace(cell, inject, serving)


def _execute(cell: Scenario, inject: bool, device) -> _Execution:
    cfg, params = _params_for(cell.arch, device)
    draft = _params_for(DRAFT_ARCH, device) if cell.spec_k > 0 else None
    if cell.mesh is not None:
        return mesh_mod.spawn(_serve_on_rank, *mesh_mod.parse_mesh(cell.mesh),
                              cell, inject, cfg, params, draft,
                              device=device, timeout=MESH_TIMEOUT_S)
    return _serve_trace(cell, inject,
                        _Serving(cfg, params, draft, resolve_device(device)))


# ---------------------------------------------------------------------------
# Cell results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellResult:
    cell: Scenario
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tokens: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    rejected: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    restarts: int = 0
    golden_checked: bool = False
    golden_diffs: List[str] = dataclasses.field(default_factory=list)
    slo_failures: List[str] = dataclasses.field(default_factory=list)
    error: str = ""

    @property
    def golden_ok(self) -> bool:
        return not self.golden_diffs

    @property
    def ok(self) -> bool:
        return not (self.error or self.golden_diffs or self.slo_failures)

    def report(self) -> Dict[str, Any]:
        """Machine-readable cell report (the ledger's scenario source)."""
        return {
            "kind": "scenario_cell",
            "cell_id": self.cell.cell_id,
            "ledger_key": self.cell.ledger_key,
            "arch": self.cell.arch,
            "scheduler": self.cell.scheduler,
            "fault": self.cell.fault,
            "prefill_chunk": self.cell.prefill_chunk,
            "prefill_budget": self.cell.prefill_budget,
            "prompt_sharing": self.cell.prompt_sharing,
            "spec_k": self.cell.spec_k,
            "mesh": self.cell.mesh,
            "seed": self.cell.seed,
            "ok": self.ok,
            "stats": self.stats,
            "rejected": [{"uid": u, "reason": r} for u, r in self.rejected],
            "restarts": self.restarts,
            "golden_checked": self.golden_checked,
            "golden_ok": self.golden_ok,
            "golden_diffs": self.golden_diffs,
            "slo_failures": self.slo_failures,
            "error": self.error,
            "requests": [
                {"uid": uid, "new_tokens": len(toks)}
                for uid, toks in sorted(self.tokens.items())
            ],
        }


def _diff_tokens(faulted: Dict[int, List[int]],
                 golden: Dict[int, List[int]]) -> List[str]:
    """Served-stream differences (empty = bit-identical on every uid)."""
    diffs = []
    for uid in sorted(golden):
        if uid not in faulted:
            diffs.append(f"uid {uid}: served in golden twin, missing here")
        elif faulted[uid] != golden[uid]:
            diffs.append(
                f"uid {uid}: tokens diverged ({faulted[uid]} != {golden[uid]})"
            )
    for uid in sorted(set(faulted) - set(golden)):
        diffs.append(f"uid {uid}: served here, absent from the golden twin")
    return diffs


def run_cell(cell: Scenario, *, check_twin: bool = True,
             device="cuda") -> CellResult:
    """Run one cell (and, when faulted, its golden twin) to a CellResult,
    on ``device``."""
    result = CellResult(cell=cell)
    try:
        ex = _execute(cell, True, device)
    except Exception as e:  # noqa: BLE001 — a cell error fails the cell, not the matrix
        result.error = f"{type(e).__name__}: {e}"
        return result
    result.stats = ex.stats
    result.tokens = ex.tokens
    result.rejected = ex.rejected
    result.restarts = ex.restarts
    if cell.fault != "none" and check_twin:
        try:
            twin = _execute(cell.twin(), False, device)
        except Exception as e:  # noqa: BLE001
            result.error = f"golden twin failed: {type(e).__name__}: {e}"
            return result
        result.golden_checked = True
        result.golden_diffs = _diff_tokens(result.tokens, twin.tokens)
    if cell.prefill_chunk > 1 and check_twin:
        # the chunk axis gets the same golden treatment as faults: chunked
        # serving must reproduce the token-by-token streams exactly
        try:
            ctwin = _execute(cell.chunk_twin(), False, device)
        except Exception as e:  # noqa: BLE001
            result.error = f"chunk twin failed: {type(e).__name__}: {e}"
            return result
        result.golden_checked = True
        result.golden_diffs += [
            f"[vs prefill_chunk=1] {d}"
            for d in _diff_tokens(result.tokens, ctwin.tokens)
        ]
    if cell.prompt_sharing == "shared" and check_twin:
        # the sharing axis gets golden treatment too: the COW engine must
        # serve the sharing-disabled twin's exact streams while actually
        # deduplicating (strictly fewer physical blocks, dedup ratio > 1)
        try:
            stwin = _execute(cell.sharing_twin(), False, device)
        except Exception as e:  # noqa: BLE001
            result.error = f"sharing twin failed: {type(e).__name__}: {e}"
            return result
        result.golden_checked = True
        result.golden_diffs += [
            f"[vs sharing-off] {d}"
            for d in _diff_tokens(result.tokens, stwin.tokens)
        ]
        mine = result.stats.get("physical_blocks")
        base = stwin.stats.get("physical_blocks")
        if mine is not None and base is not None and not mine < base:
            result.golden_diffs.append(
                f"[vs sharing-off] physical blocks not reduced "
                f"({mine} vs {base})")
        if float(result.stats.get("block_dedup_ratio", 1.0)) <= 1.0:
            result.golden_diffs.append(
                "[vs sharing-off] block_dedup_ratio "
                f"{result.stats.get('block_dedup_ratio')} <= 1 on "
                "shared-prefix traffic")
    if cell.spec_k > 0 and check_twin:
        # the speculation axis gets golden treatment too: the speculative
        # engine must serve the speculation-off twin's exact streams while
        # actually drafting (drafted > 0 and acceptance recorded); step
        # counts are NOT asserted here — acceptance-hostile cells (draft
        # disagreeing with the target) legitimately spend extra replay
        # steps
        try:
            vtwin = _execute(cell.spec_twin(), False, device)
        except Exception as e:  # noqa: BLE001
            result.error = f"spec twin failed: {type(e).__name__}: {e}"
            return result
        result.golden_checked = True
        result.golden_diffs += [
            f"[vs spec-off] {d}"
            for d in _diff_tokens(result.tokens, vtwin.tokens)
        ]
        if (result.stats.get("requests", 0)
                and not result.stats.get("drafted_tokens", 0)):
            result.golden_diffs.append(
                "[vs spec-off] speculative cell drafted zero tokens")
    if cell.mesh is not None and check_twin:
        # the mesh axis gets golden treatment too: the sharded engine must
        # serve the unsharded twin's exact streams — head/expert/data
        # sharding may move the math across devices, never change it
        try:
            mtwin = _execute(cell.mesh_twin(), False, device)
        except Exception as e:  # noqa: BLE001
            result.error = f"mesh twin failed: {type(e).__name__}: {e}"
            return result
        result.golden_checked = True
        result.golden_diffs += [
            f"[vs mesh-off] {d}"
            for d in _diff_tokens(result.tokens, mtwin.tokens)
        ]
    result.slo_failures = cell.slo.check(result.stats)
    return result


def record_cell(result: CellResult, ledger=None, *, env=None):
    """Append one BenchRun for this cell to the perf ledger; the row is
    keyed ``scenario/<cell_id>`` so ``python -m repro_torch.perf gate``
    compares each cell only against its own trajectory.  ``env`` (a
    :class:`~repro_torch.perf.ledger.RunEnv`) defaults to the process's
    stamp on the reference's default chip."""
    from repro_torch.perf.ledger import default_ledger, metrics_from_scenario

    ledger = ledger or default_ledger()
    return ledger.record(
        metrics_from_scenario(result.report()), env=env,
        meta={"sources": ["scenario"], "scenario": result.cell.cell_id,
              "fault": result.cell.fault},
    )


def run_matrix(spec: MatrixSpec, *, only: Optional[str] = None,
               jobs: int = 1, check_twin: bool = True,
               record: bool = False, ledger=None,
               device="cuda") -> List[CellResult]:
    """Expand and run the matrix on ``device``; optionally record one
    BenchRun per cell that did not error, stamped with the chip of
    ``device`` (``h100`` on the card, ``grace-core`` on the CPU).

    ``only`` is an fnmatch glob over cell ids (``"*device-loss"``,
    ``"*continuous*gpt2*"``); ``jobs > 1`` fans cells over a thread pool,
    one engine (cache and block pool) a cell.
    """
    cells = spec.cells()
    if only:
        cells = [c for c in cells if fnmatch.fnmatch(c.cell_id, only)]
    if jobs > 1 and len(cells) > 1:
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            results = list(pool.map(
                lambda c: run_cell(c, check_twin=check_twin, device=device),
                cells))
    else:
        results = [run_cell(c, check_twin=check_twin, device=device)
                   for c in cells]
    if record:
        from repro_torch.perf.ledger import capture_env, device_chip

        env = capture_env(chip=device_chip(device))
        for r in results:
            if not r.error:
                record_cell(r, ledger=ledger, env=env)
    return results


def format_matrix_markdown(results: List[CellResult]) -> str:
    """The per-cell matrix report CI uploads."""
    lines = [
        "# Scenario matrix",
        "",
        f"{sum(r.ok for r in results)}/{len(results)} cells ok",
        "",
        "| cell | tok/s | p95 (s) | ttft p95 (s) | util | rej | pre | rst "
        "| twin | slo |",
        "|---|---:|---:|---:|---:|---:|---:|---:|:-:|:-:|",
    ]
    for r in results:
        s = r.stats
        if r.error:
            lines.append(f"| `{r.cell.cell_id}` | — | — | — | — | — | — | — "
                         f"| — | ERROR: {r.error} |")
            continue
        twin = ("=" if r.golden_checked and r.golden_ok
                else ("DIFF" if r.golden_checked else "n/a"))
        slo = "ok" if not r.slo_failures else "; ".join(r.slo_failures)
        lines.append(
            f"| `{r.cell.cell_id}` | {s.get('tok_s', 0):.1f} "
            f"| {s.get('p95_latency_s', 0):.3f} "
            f"| {s.get('ttft_p95_s', 0):.3f} "
            f"| {s.get('slot_utilization', 0):.3f} "
            f"| {s.get('rejected', 0)} | {s.get('preemptions', 0)} "
            f"| {s.get('restarts', 0)} | {twin} | {slo} |"
        )
    lines.append("")
    return "\n".join(lines)
