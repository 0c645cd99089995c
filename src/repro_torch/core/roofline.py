"""The paper's adapted roofline model (Eq. 2), the first half of
:mod:`repro.core.roofline`.

A scalar ceiling, a vectorized ceiling boosted by VLEN/ELEN, and the
inflection points AI_IRR = scalar peak / BW and AI_IRV = AI_IRR * VLEN/ELEN.
Reducing ELEN (or lengthening VLEN) raises the compute ceiling AND moves the
inflection right (paper Fig. 7).  The reference's three-term deployment
roofline and ``model_flops_*`` come with the dry-run (ROADMAP item 1.19).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import hw
from repro_torch.core.metrics import vectorization_bound


@dataclasses.dataclass(frozen=True)
class AdaptedRoofline:
    """Paper's roofline for one (chip, dtype): ceilings + inflection points."""

    chip: str
    dtype: str
    scalar_peak: float  # FLOP/s, vectorization disabled
    vector_peak: float  # FLOP/s, ideal vectorization (= scalar * VB)
    bw: float  # bytes/s
    ai_irr: float  # scalar inflection (paper: AI_IRR)
    ai_irv: float  # vectorized inflection (paper: AI_IRV = AI_IRR * VLEN/ELEN)
    vb: float

    def attainable(self, ai: float, vectorized: bool = True) -> float:
        """Attainable FLOP/s at arithmetic intensity ``ai``."""
        peak = self.vector_peak if vectorized else self.scalar_peak
        return min(peak, ai * self.bw)

    def predicted_speedup(self, ai: float) -> float:
        """Vectorization speedup the model predicts at intensity ``ai``.

        Saturates at VB in the compute-bound region and decays toward 1 in
        the memory-bound region — the paper's Fig. 6 curve.
        """
        s = self.attainable(ai, True) / max(self.attainable(ai, False), 1e-30)
        return max(1.0, s)

    def region(self, ai: float, vectorized: bool = True) -> str:
        knee = self.ai_irv if vectorized else self.ai_irr
        return "memory-bound" if ai < knee else "compute-bound"


def adapted_roofline(
    chip: hw.ChipSpec, dtype: str, *, scalar_dtype: str | None = None
) -> AdaptedRoofline:
    vb = vectorization_bound(chip, dtype)
    if scalar_dtype is None:
        scalar_dtype = "scalar_" + dtype if ("scalar_" + dtype) in chip.peak_flops else "scalar"
    scalar_peak = (
        chip.peak_flops[scalar_dtype]
        if scalar_dtype in chip.peak_flops
        else chip.peak(dtype) / vb
    )
    vector_peak = (
        chip.peak(dtype) if dtype in chip.peak_flops else scalar_peak * vb
    )
    ai_irr = scalar_peak / chip.hbm_bw
    # paper Eq. 2: AI_IRV = AI_IRR * VLEN/ELEN — equivalently vector_peak/BW
    ai_irv = vector_peak / chip.hbm_bw
    return AdaptedRoofline(
        chip=chip.name,
        dtype=dtype,
        scalar_peak=scalar_peak,
        vector_peak=vector_peak,
        bw=chip.hbm_bw,
        ai_irr=ai_irr,
        ai_irv=ai_irv,
        vb=vb,
    )
