"""Serving metrics (a subset of :mod:`repro.core.metrics`).

The reference module also holds the paper's vectorization metrics, which
need its hardware model; the serving engine needs only these four, copied
here so the port imports nothing of the reference.
"""

from __future__ import annotations

from typing import Sequence


def slot_utilization(
    busy_slot_steps: float, steps: float, slots: int
) -> float:
    """Fraction of serving slots doing useful work across a batch of fused
    decode steps: ``busy_slot_steps / (steps * slots)``, clamped to 1.

    A fused decode step is a vector issue whose "lanes" are the batch
    slots; a slot is busy when it carries a live request (consuming prompt
    or generating) and idle when it is drained or unfilled.
    """
    if steps <= 0 or slots <= 0:
        return 0.0
    return min(1.0, busy_slot_steps / (steps * slots))


def acceptance_rate(accepted: float, drafted: float) -> float:
    """Accepted draft tokens per token drafted; 0.0 when nothing was
    drafted (speculation off)."""
    if drafted <= 0:
        return 0.0
    return min(1.0, accepted / drafted)


def block_dedup_ratio(bytes_served: float, bytes_stored: float) -> float:
    """KV-cache bytes served per byte physically stored; 1.0 means no
    sharing, and also stands for the degenerate nothing-stored case."""
    if bytes_stored <= 0:
        return 1.0
    return bytes_served / bytes_stored


def device_lane_utilization(
    busy_lane_steps: Sequence[float], steps: float, lanes_per_device: int
) -> float:
    """Busy-lane fraction of the *worst* device shard: each shard's busy
    count over ``steps * lanes_per_device``, minimised over shards.  On a
    single shard this is :func:`slot_utilization`."""
    counts = list(busy_lane_steps)
    if steps <= 0 or lanes_per_device <= 0 or not counts:
        return 0.0
    return min(
        min(1.0, b / (steps * lanes_per_device)) for b in counts
    )
