"""Vectorization-effectiveness metrics (paper Eq. 1 and Sec. 3.3) and the
serving metrics: a copy of :mod:`repro.core.metrics` less
``expert_imbalance`` (ROADMAP item 1.10).

* ``vectorization_bound`` — VB = VLEN / ELEN (paper Eq. 1, left).
* ``instruction_reduction`` — R_ins_reduction = Ins_nonvec / Ins_vec
  (paper Eq. 1, right).
* ``arithmetic_intensity`` — AI = FLOPs / bytes from main memory.
* ``vector_issues`` — how many vector issue slots an element count takes
  at an element width, with predication for ragged extents.

The scalar baseline is one element per issue slot, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import hw


def vectorization_bound(chip: hw.ChipSpec, dtype: str) -> float:
    """VB = VLEN / ELEN (paper Eq. 1).

    On Grace: VB(fp64)=2, VB(fp32)=4.  On TPU the VPU issue is 8x128 32-bit
    lanes, with sub-32-bit types packed 2x/4x — the same ELEN scaling the
    paper studies, at a longer base vector.
    """
    return chip.vlen_bits / hw.elen_bits(dtype)


def packing_factor(dtype: str, base_bits: int = 32) -> float:
    """Relative element packing vs a 32-bit lane (TPU-native comparison).

    bf16 -> 2.0, fp32 -> 1.0, int8 -> 4.0, fp64 -> 0.5.  This is the ratio the
    paper sweeps by changing ELEN at fixed VLEN.
    """
    return base_bits / hw.elen_bits(dtype)


def vector_issues(
    elements: float,
    dtype: str,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
    *,
    ragged_extents: Sequence[int] | None = None,
    tile: int | None = None,
) -> float:
    """Number of vector issue slots to process ``elements`` elements.

    ``ragged_extents`` models the paper's SpMV case: each row of length
    ``r`` occupies ``ceil(r / tile)`` tiles under predication (SVE/VLA
    analogue: masked Pallas tiles), instead of ``ceil(max_r / tile)`` under
    fixed-width padding.  ``tile`` defaults to the chip's full vector issue
    width in elements.
    """
    lanes = chip.vlen_bits / hw.elen_bits(dtype)
    t = tile if tile is not None else lanes
    if ragged_extents is None:
        return math.ceil(elements / t) if elements else 0.0
    return float(sum(math.ceil(max(r, 0) / t) for r in ragged_extents))


def scalar_issues(elements: float) -> float:
    """Scalar baseline: one element per retired instruction."""
    return float(elements)


def instruction_reduction(ins_nonvec: float, ins_vec: float) -> float:
    """R_ins_reduction = Ins_nonvec / Ins_vec (paper Eq. 1)."""
    if ins_vec <= 0:
        return float("inf") if ins_nonvec > 0 else 1.0
    return ins_nonvec / ins_vec


def lane_utilization(
    useful_elements: float, issues: float, dtype: str, chip: hw.ChipSpec
) -> float:
    """Fraction of vector lanes doing useful work (predication efficiency)."""
    lanes = chip.vlen_bits / hw.elen_bits(dtype)
    if issues <= 0:
        return 0.0
    return min(1.0, useful_elements / (issues * lanes))


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


def arithmetic_intensity(flops: float, hbm_bytes: float) -> float:
    """AI = FLOPs / bytes moved from main memory (paper Sec. 3.3)."""
    if hbm_bytes <= 0:
        return float("inf") if flops > 0 else 0.0
    return flops / hbm_bytes


@dataclasses.dataclass(frozen=True)
class VectorizationReport:
    """Everything the decision tree needs about one kernel/application run."""

    name: str
    dtype: str
    flops: float
    hbm_bytes: float
    gather_bytes: float  # pointer-chasing traffic (latency-bound signal)
    ins_scalar: float  # scalar-equivalent retired instructions
    ins_vec: float  # vector-issue count of the vectorized version
    vectorizable_fraction: float  # share of FLOPs in vector/matrix-eligible ops
    collective_bytes: float = 0.0

    @property
    def r_ins(self) -> float:
        return instruction_reduction(self.ins_scalar, self.ins_vec)

    @property
    def ai(self) -> float:
        return arithmetic_intensity(self.flops, self.hbm_bytes)

    @property
    def gather_fraction(self) -> float:
        if self.hbm_bytes <= 0:
            return 0.0
        return self.gather_bytes / self.hbm_bytes


def amdahl_r_ins(vb: float, vectorizable_fraction: float) -> float:
    """Analytic R_ins for a partially vectorizable instruction stream.

    The paper observes (Sec. 4.1) that when non-vectorized instructions grow
    (e.g. threading runtime), R_ins collapses even though kernels vectorize.
    Amdahl over the instruction stream: R = 1 / ((1-f) + f/VB).
    """
    f = min(max(vectorizable_fraction, 0.0), 1.0)
    return 1.0 / ((1.0 - f) + f / max(vb, 1e-30))
