"""Fault plans: declarative fault dimensions for scenario cells.

Port of ``repro/scenarios/faults.py``, plan for plan.

Each plan is one value of the matrix's fault axis.  The contract every
plan must uphold — and the runner asserts against the fault-free golden
twin — is **no served token may ever differ**: faults may cost steps,
latency, or restarts, never correctness.

* ``none``         — the golden baseline every faulted cell is diffed against.
* ``preempt``      — mid-flight slot eviction via a step hook calling
  :meth:`repro_torch.serve.engine.ServeEngine.preempt`; the engine replays the
  evicted request's prompt + already-served tokens through a rebuilt cache
  (continuous scheduler only: waves have no slots to steal).
* ``device-loss``  — a raised :class:`SimulatedDeviceLoss` mid-drain; the
  runner executes these cells under
  :class:`~repro_torch.distributed.fault_tolerance.ResilientLoop` over a
  :class:`~repro_torch.checkpoint.CheckpointStore`, so the crash restores the
  newest committed chunk and replays (see ``runner._execute_resilient``).
* ``malformed``    — oversized and empty submissions injected into the
  trace; both must be rejected typed at submit() and counted, never
  crash the drain or perturb well-formed requests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.scenarios.matrix import Scenario
from repro_torch.scenarios.traffic import RequestSpec


class SimulatedDeviceLoss(RuntimeError):
    """The injected 'device fell over' signal: on real fleets this is the
    preemption notice / process death; here it is a typed exception the
    ResilientLoop's restart policy catches."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The no-op plan ('none') and the base interface."""

    name: str = "none"

    def applies_to(self, cell: Scenario) -> bool:
        return True

    def mutate_trace(self, trace: List[RequestSpec],
                     cell: Scenario) -> List[RequestSpec]:
        return trace

    def make_hook(self, cell: Scenario):
        """Step hook injected into the engine, or None."""
        return None

    @property
    def resilient(self) -> bool:
        """True when the runner must execute the cell under the
        checkpoint-restart loop (chunked serving)."""
        return False


class _PreemptHook:
    """Evict the deepest busy slot every ``every`` fused steps, ``times``
    times total.  Deterministic: driven by the engine's step counter and
    the engine's own deterministic victim choice."""

    def __init__(self, every: int, times: int):
        self.every = every
        self.left = times
        self.next_at = every

    def __call__(self, engine, busy: bool) -> bool:
        if self.left > 0 and busy and engine.steps >= self.next_at:
            if engine.preempt() is not None:
                self.left -= 1
            self.next_at = engine.steps + self.every
        return False  # never holds the drain open


@dataclasses.dataclass(frozen=True)
class PreemptPlan(FaultPlan):
    name: str = "preempt"
    every: int = 5  # fused steps between evictions
    times: int = 2

    def applies_to(self, cell: Scenario) -> bool:
        return cell.scheduler == "continuous"

    def make_hook(self, cell: Scenario):
        return _PreemptHook(self.every, self.times)


class _CrashOnce:
    """Raise SimulatedDeviceLoss at one fused step, once — the analogue of
    :class:`tests.test_checkpoint_ft._Flaky` for the serve path."""

    def __init__(self, at_step: int):
        self.at_step = at_step
        self.armed = True

    def __call__(self, engine, busy: bool) -> bool:
        if self.armed and engine.steps >= self.at_step:
            self.armed = False
            raise SimulatedDeviceLoss(
                f"injected device loss at fused step {engine.steps}"
            )
        return False


@dataclasses.dataclass(frozen=True)
class DeviceLossPlan(FaultPlan):
    name: str = "device-loss"
    fail_chunk: int = 1  # which serve chunk the device dies in
    fail_step: int = 3   # fused steps into that chunk

    @property
    def resilient(self) -> bool:
        return True

    def make_crash_hook(self) -> _CrashOnce:
        return _CrashOnce(self.fail_step)


@dataclasses.dataclass(frozen=True)
class MalformedPlan(FaultPlan):
    """Inject an oversized request (prompt + budget exceeds the per-slot
    cache) and an empty-prompt request.  Injected uids live in their own
    range so twin diffs can never confuse them with sampled traffic."""

    name: str = "malformed"
    uid_base: int = 100_000

    def mutate_trace(self, trace: List[RequestSpec],
                     cell: Scenario) -> List[RequestSpec]:
        rng = np.random.default_rng(cell.seed ^ 0x5EED)
        oversized = RequestSpec(
            uid=self.uid_base,
            arrive_step=0,
            prompt=rng.integers(0, 2, size=cell.max_len + 8).astype(np.int32),
            max_new_tokens=cell.max_new,
            malformed="oversized",
        )
        empty = RequestSpec(
            uid=self.uid_base + 1,
            arrive_step=0,
            prompt=np.zeros((0,), np.int32),
            max_new_tokens=cell.max_new,
            malformed="empty",
        )
        out = list(trace) + [oversized, empty]
        out.sort(key=lambda r: (r.arrive_step, r.uid))
        return out


PLANS = {p.name: p for p in (
    FaultPlan(), PreemptPlan(), DeviceLossPlan(), MalformedPlan(),
)}


def get_plan(name: str) -> FaultPlan:
    if name not in PLANS:
        raise KeyError(f"unknown fault plan {name!r}; have {sorted(PLANS)}")
    return PLANS[name]
