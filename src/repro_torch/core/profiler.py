"""Region-of-interest profiler mirroring the paper's perf wrapper API (a
copy of :mod:`repro.core.profiler` for PyTorch).

The paper extends a lightweight perf library with four calls:
``configure_measure() / start_measure() / stop_measure() / print_results()``.
We keep that exact API.  Counters come from two sources:

* **wall-clock** — host-clock time of the ROI; work on a CUDA card is
  waited for (:func:`block_until_ready`) before the clock stops;
* **artifact events** — the PMU-analogue counters of ``counters.Events``,
  attached by the caller (usually from a jitted function's lowered/compiled
  artifact, or an app's analytic model).

In Neoverse V2 at most six events can be collected per group (paper Sec. 3.1);
we keep a ``max_events`` knob for API fidelity, though artifact counters have
no such limit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.counters import Events

DEFAULT_EVENTS = (
    "INST_RETIRED",
    "LL_CACHE_MISS_RD",
    "MEM_ACCESS_RD",
    "STALL_BACKEND",
    "CPU_CYCLES",
    "VFP_SPEC",
)


@dataclasses.dataclass
class Measurement:
    name: str
    wall_s: float
    counters: Dict[str, float]
    repeats: int = 1


class Profiler:
    """configure/start/stop/print, as in the paper's profiler library."""

    def __init__(self, events: tuple = DEFAULT_EVENTS, max_events: int = 6):
        if len(events) > max_events:
            raise ValueError(
                f"at most {max_events} events per group (Neoverse V2 PMU limit)"
            )
        self.events = events
        self._configured = False
        self._t0: Optional[float] = None
        self._acc = 0.0
        self._repeats = 0
        self.results: List[Measurement] = []

    def configure_measure(self) -> None:
        self._configured = True
        self._acc = 0.0
        self._repeats = 0

    def start_measure(self) -> None:
        if not self._configured:
            raise RuntimeError("configure_measure() first")
        self._t0 = time.perf_counter()

    def stop_measure(self) -> None:
        if self._t0 is None:
            raise RuntimeError("start_measure() first")
        self._acc += time.perf_counter() - self._t0
        self._repeats += 1
        self._t0 = None

    def mean_roi_s(self) -> float:
        """Mean wall-clock seconds per measured ROI repeat so far.

        Public accessor for the accumulated start/stop timings (0.0 before
        any completed repeat) — callers should use this instead of reaching
        into the accumulator fields.
        """
        return self._acc / max(self._repeats, 1)

    def record(self, name: str, events: Events, chip_clock_hz: float = 3.447e9) -> Measurement:
        """Attach artifact counters to the timed ROI and store the result.

        Maps Events -> the paper's Table-1 counter names (see counters.py).
        """
        mem_read_tx = events.hbm_read_bytes / 64.0  # Grace line-sized units
        counters = {
            "INST_RETIRED": events.flops,  # refined by apps via issue model
            "LL_CACHE_MISS_RD": mem_read_tx,
            "MEM_ACCESS_RD": events.bytes_accessed / 64.0,
            "STALL_BACKEND": 0.0,
            "CPU_CYCLES": self._acc * chip_clock_hz,
            "VFP_SPEC": events.flops,
        }
        m = Measurement(
            name=name,
            wall_s=self.mean_roi_s(),
            counters=counters,
            repeats=self._repeats,
        )
        self.results.append(m)
        return m

    def print_results(self) -> str:
        lines = []
        for m in self.results:
            lines.append(f"[ROI {m.name}] wall={m.wall_s*1e3:.3f} ms x{m.repeats}")
            for k in self.events:
                if k in m.counters:
                    lines.append(f"  {k:<18} {m.counters[k]:.4g}")
        out = "\n".join(lines)
        print(out)
        return out


def block_until_ready(out: Any) -> Any:
    """The port's ``jax.block_until_ready``: wait for the card's queued
    work where CUDA is in use; returns ``out``."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def time_fn(fn, *args, repeats: int = 5, min_time_s: float = 0.1, **kw) -> float:
    """Paper methodology: >=5 repeats, total time >= 0.1 s; returns best-of."""
    # warmup
    block_until_ready(fn(*args, **kw))
    times = []
    total = 0.0
    i = 0
    while i < repeats or total < min_time_s:
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kw))
        dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
        i += 1
        if i > 1000:
            break
    return min(times)
