"""The paper's decision tree (Fig. 8): classify SVE/vector-boosted performance
(a copy of :mod:`repro.core.decision_tree`).

Four classes, determined from NON-vectorized profile metrics only:

* ``Class 1 — NOT_VECTORIZED``: the kernel cannot be vectorized effectively
  (R_ins ~ 1, or the vectorizable instruction share is tiny: complex control
  flow, library pre-optimization (FFTW), recursion, threading-runtime
  dominance).
* ``Class 2 — MEMORY_BANDWIDTH_BOUND``: vectorizes (R_ins >> 1) but AI is
  left of the inflection point and traffic is streaming — more bandwidth, not
  vectors, is the fix (STREAM; QC sim at 72 threads).
* ``Class 3 — MEMORY_LATENCY_BOUND``: vectorizes, AI left of inflection, and
  the traffic is pointer-chasing (LLC miss ratio above the ideal-streaming
  threshold in the paper; gather-byte share here) — SpMV.
* ``Class 4 — SPEEDUP``: AI right of the inflection point — compute bound,
  vectorization pays (GEMM, CNNs, LLM kernels, AutoDock).

Paper thresholds, kept as defaults and overridable:
  - effective vectorization:   R_ins >= 1.2 (paper: "R_ins_reduction > 1")
  - memory- vs compute-bound:  AI vs AI_inflection = scalar peak / BW
  - latency- vs bandwidth-:    miss-ratio ELEN/cache_line (Grace: 8B/64B = 13%)
    -> TPU: gather-byte share of HBM traffic vs ELEN/transaction granule.
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.core import hw
from repro_torch.core.metrics import VectorizationReport
from repro_torch.core.roofline import AdaptedRoofline, adapted_roofline


class PerfClass(enum.IntEnum):
    NOT_VECTORIZED = 1
    MEMORY_BANDWIDTH_BOUND = 2
    MEMORY_LATENCY_BOUND = 3
    SPEEDUP = 4

    def describe(self) -> str:
        return {
            PerfClass.NOT_VECTORIZED: "cannot be vectorized effectively",
            PerfClass.MEMORY_BANDWIDTH_BOUND: "vectorizes; bandwidth-bound, no speedup",
            PerfClass.MEMORY_LATENCY_BOUND: "vectorizes; latency-bound (pointer chasing)",
            PerfClass.SPEEDUP: "compute-bound; vectorization yields speedup",
        }[self]


@dataclasses.dataclass(frozen=True)
class Decision:
    perf_class: PerfClass
    r_ins: float
    ai: float
    ai_inflection: float
    gather_fraction: float
    latency_threshold: float
    rationale: str


def classify(
    report: VectorizationReport,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
    *,
    r_ins_threshold: float = 1.2,
    roofline: AdaptedRoofline | None = None,
) -> Decision:
    """Run the paper's decision tree on one profiled kernel/application."""
    rl = roofline or adapted_roofline(chip, report.dtype)
    # Stage 1 — can it vectorize?  (paper: R_ins_reduction filter)
    r_ins = report.r_ins
    effective = r_ins >= r_ins_threshold and report.vectorizable_fraction >= 0.10
    # Stage 2 — memory- or compute-bound?  AI vs inflection (scalar knee:
    # the tree takes the NON-vectorized profile, paper Fig. 8).
    ai = report.ai
    knee = rl.ai_irr
    # Stage 3 — latency or bandwidth?  Grace: LLC miss ratio vs ELEN/line.
    latency_threshold = hw.elen_bits(report.dtype) / 8 / chip.transaction_bytes
    # TPU transactions are 512B so the structural gather share is the signal;
    # keep the paper's Grace threshold shape: ideal streaming ratio ~ 13%.
    latency_threshold = max(latency_threshold, 0.13)

    if not effective:
        cls = PerfClass.NOT_VECTORIZED
        why = (
            f"R_ins={r_ins:.2f} < {r_ins_threshold} or vectorizable FLOP share "
            f"{report.vectorizable_fraction:.2%} < 10%"
        )
    elif ai >= knee:
        cls = PerfClass.SPEEDUP
        why = f"AI={ai:.3g} >= inflection {knee:.3g} flop/B: compute-bound"
    elif report.gather_fraction > latency_threshold:
        cls = PerfClass.MEMORY_LATENCY_BOUND
        why = (
            f"AI={ai:.3g} < {knee:.3g} and gather share "
            f"{report.gather_fraction:.2%} > {latency_threshold:.2%}"
        )
    else:
        cls = PerfClass.MEMORY_BANDWIDTH_BOUND
        why = f"AI={ai:.3g} < inflection {knee:.3g} flop/B, streaming traffic"
    return Decision(
        perf_class=cls,
        r_ins=r_ins,
        ai=ai,
        ai_inflection=knee,
        gather_fraction=report.gather_fraction,
        latency_threshold=latency_threshold,
        rationale=why,
    )
