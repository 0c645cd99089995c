"""Fault tolerance for long runs: checkpoint-restart and straggler
detection.

Port of ``repro/distributed/fault_tolerance.py``: the control logic
(restart policy, straggler detection, elastic placement on restore) as
testable pure components; the transport (process death, a preemption
notice) is the platform's.

* **Checkpoint-restart**: ``ResilientLoop`` wraps a step function; on any
  exception it restores the newest committed checkpoint and replays from
  there (a step function whose inputs depend only on the step replays
  exactly).
* **Straggler detection**: each step's wall time is held against the
  median of a rolling window; a step slower than ``straggler_factor``
  times the median is logged and counted.
* **Elastic placement**: ``ResilientLoop(device=...)`` restores every
  array onto that device (``CheckpointStore.restore(device=...)``), so a
  restarted rank takes its state wherever it now runs.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Dict

import torch

from repro_torch.checkpoint import CheckpointStore

log = logging.getLogger("repro_torch.fault_tolerance")


@dataclasses.dataclass
class FaultToleranceConfig:
    checkpoint_every: int = 100
    keep: int = 3
    max_restarts: int = 10
    straggler_factor: float = 2.0
    straggler_window: int = 32
    async_save: bool = True


def _shapes_only(tree: Any) -> Any:
    """``tree`` with each tensor leaf replaced by an empty one of its shape
    and dtype on the meta device (no storage)."""
    if isinstance(tree, dict):
        return {k: _shapes_only(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes_only(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


class FaultAt:
    """A step hook (``launch.train.train(job, hook=...)``) that raises the
    first time it sees step ``step``: an injected fault, which the
    resilient loop survives by restoring the newest checkpoint.  Pickled
    to each rank of a mesh, it fires on every rank at that step."""

    def __init__(self, step: int):
        self.step = step
        self.fired = False

    def __call__(self, step: int) -> None:
        if step == self.step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected fault at step {step}")


class StragglerDetector:
    def __init__(self, factor: float, window: int):
        self.factor = factor
        self.times: deque = deque(maxlen=window)
        self.events = 0

    def observe(self, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.factor * med:
                self.events += 1
                is_straggler = True
                log.warning("straggler step: %.3fs vs median %.3fs", dt, med)
        self.times.append(dt)
        return is_straggler


class ResilientLoop:
    """Run (step_fn, state) to `total_steps` surviving injected failures."""

    def __init__(
        self,
        store: CheckpointStore,
        cfg: FaultToleranceConfig,
        step_fn: Callable[[int, Any], Any],
        make_initial_state: Callable[[], Any],
        *,
        device=None,
    ):
        self.store = store
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_initial_state = make_initial_state
        self.device = device
        self.straggler = StragglerDetector(cfg.straggler_factor,
                                           cfg.straggler_window)
        self.restarts = 0

    def _restore_or_init(self):
        latest = self.store.latest_step()
        if latest is None:
            return 0, self.make_initial_state()
        template = self.make_initial_state()
        if self.device is not None:
            # placing every array on the device, the restore reads only the
            # template's structure, shapes and dtypes: keep those and free
            # its storage before the checkpoint's arrays land there
            template = _shapes_only(template)
        step, state, _ = self.store.restore(
            template, step=latest, device=self.device
        )
        log.info("restored checkpoint at step %d", step)
        return step, state

    def run(self, total_steps: int) -> Dict[str, Any]:
        step, state = self._restore_or_init()
        while step < total_steps:
            try:
                t0 = time.perf_counter()
                state = self.step_fn(step, state)
                self.straggler.observe(time.perf_counter() - t0)
                step += 1
                if step % self.cfg.checkpoint_every == 0 or step == total_steps:
                    self.store.save(
                        step, state, blocking=not self.cfg.async_save,
                        extra={"data_step": step},
                    )
                continue
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — restart on any step fault
                self.restarts += 1
                log.error("step %d failed (%s); restart %d", step, str(e),
                          self.restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
            # out of the handler, so that neither the exception's frames nor
            # ``state`` hold the failed step's tensors during the restore
            state = None
            step, state = self._restore_or_init()
        self.store.wait()
        return {
            "final_step": step,
            "restarts": self.restarts,
            "straggler_events": self.straggler.events,
            "state": state,
        }
