"""Hardware models for the adapted roofline / vectorization-bound analysis
(a copy of :mod:`repro.core.hw`, plus the port's own card).

The paper (ARM SVE Unleashed) parameterizes its analysis by three hardware
quantities: the vector length VLEN, the peak compute throughput, and the
peak memory bandwidth.  The reference's four chip models are copied
verbatim, so an analysis on ``grace-core`` or ``tpu-v5e`` equals the
reference's; :data:`H100` adds the card the port runs on.

``H100`` models one NVIDIA H100 SXM5 (80 GB HBM3) from NVIDIA's H100 data
sheet: dense (no sparsity) peaks of 34 TFLOP/s fp64, 67 TFLOP/s fp32,
989 TFLOP/s bf16/fp16 on the tensor cores, 1979 TOP/s int8; 3.35 TB/s
HBM3; NVLink 4 with 18 links, 900 GB/s in all.  Its ``vlen_bits`` is a
modelling choice, not a hardware register: 1024 bits, one warp
instruction of 32 lanes x 32 bits, so VB(fp32) = 32 and VB(bf16) = 64.
The scalar baseline is one lane of such an instruction: ``"scalar"`` is
the fp32 peak over 32.  A warp also issues 32 fp64 lanes (where
1024 / 64 would say 16), so ``"scalar_fp64"`` is the fp64 peak over 32.
``transaction_bytes`` is one 32-byte L2 sector.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip hardware model used by the roofline and VB metrics."""

    name: str
    # Peak dense compute throughput per chip, FLOP/s, keyed by element type.
    peak_flops: Mapping[str, float]
    # Peak HBM/DRAM bandwidth per chip, bytes/s.
    hbm_bw: float
    # Inter-chip interconnect bandwidth per link, bytes/s (0 for single-socket).
    ici_bw_per_link: float
    # Number of ICI links per chip that can be driven concurrently.
    ici_links: int
    # Native vector width in bits for the vector (non-matrix) engine.
    vlen_bits: int
    # Memory transaction granule in bytes (cache line / HBM burst).
    transaction_bytes: int
    # MXU dims (0 if no matrix engine).
    mxu_dim: int = 0

    def peak(self, dtype: str = "bf16") -> float:
        if dtype not in self.peak_flops:
            raise KeyError(
                f"{self.name}: no peak for dtype {dtype!r}; "
                f"have {sorted(self.peak_flops)}"
            )
        return self.peak_flops[dtype]

    def ici_bw(self) -> float:
        return self.ici_bw_per_link * max(self.ici_links, 1)


#: Element sizes in bits for the dominant data formats (paper's ELEN).
ELEN_BITS: Mapping[str, int] = {
    "fp64": 64,
    "f64": 64,
    "float64": 64,
    "fp32": 32,
    "f32": 32,
    "float32": 32,
    "tf32": 32,
    "bf16": 16,
    "fp16": 16,
    "f16": 16,
    "float16": 16,
    "bfloat16": 16,
    "int8": 8,
    "s8": 8,
    "fp8": 8,
    "int4": 4,
}


def elen_bits(dtype: str) -> int:
    key = str(dtype).lower()
    if key not in ELEN_BITS:
        raise KeyError(f"unknown element type {dtype!r}")
    return ELEN_BITS[key]


# --- The paper's platform: Nvidia Grace (Neoverse V2), 128-bit SVE -----------
# Peak FP64/chip-core: 4 FPU pipes x 2 FLOP (FMA) x 2 lanes (128b/64b) x 3.447GHz.
# We model a single core (the paper's single-thread analysis) and the full
# 72-core socket; STREAM-measured bandwidth per the paper: 30 GB/s @1T,
# 250 GB/s @72T.
_GRACE_CORE_FP64_SCALAR = 4 * 2 * 3.447e9  # 4 pipes, FMA, scalar (1 elem)

GRACE_CORE = ChipSpec(
    name="grace-core",
    peak_flops={
        # scalar baseline (vectorization disabled) — 1 element per issue
        "scalar_fp64": _GRACE_CORE_FP64_SCALAR,
        "scalar_fp32": _GRACE_CORE_FP64_SCALAR,
        # vectorized peaks = scalar x VB
        "fp64": _GRACE_CORE_FP64_SCALAR * 2,
        "fp32": _GRACE_CORE_FP64_SCALAR * 4,
        "fp16": _GRACE_CORE_FP64_SCALAR * 8,
        # Neoverse V2 SVE carries the BF16 extension (BFDOT/BFMMLA); same
        # 16-bit lane packing as fp16 — needed by the ELEN-packing tuning axis
        "bf16": _GRACE_CORE_FP64_SCALAR * 8,
    },
    hbm_bw=30e9,  # single-thread STREAM triad (paper Sec. 3)
    ici_bw_per_link=0.0,
    ici_links=0,
    vlen_bits=128,
    transaction_bytes=64,  # LLC line (paper Sec. 5: 64-byte line)
)

GRACE_SOCKET = dataclasses.replace(
    GRACE_CORE,
    name="grace-socket-72c",
    peak_flops={k: v * 72 for k, v in GRACE_CORE.peak_flops.items()},
    hbm_bw=250e9,  # 72-thread STREAM triad (paper Sec. 3)
)


# --- Target platform: TPU v5e ------------------------------------------------
# Constants fixed by the assignment: 197 TFLOP/s bf16/chip, 819 GB/s HBM,
# ~50 GB/s/link ICI.  fp32 matmul runs the MXU in passes -> 1/2 bf16; int8 2x.
# The VPU is (8 sublanes x 128 lanes) of 32-bit elements per issue.
TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops={
        "bf16": 197e12,
        "fp32": 98.5e12,
        "int8": 394e12,
        # scalar-equivalent baseline: one element per issue slot at VPU clock.
        # 197e12 / (2 flop/MAC) / (128*128 MACs) ~= 6.0e9 issue slots/s; the
        # scalar model charges 2 FLOP per slot.
        "scalar": 197e12 / (128 * 128),
    },
    hbm_bw=819e9,
    ici_bw_per_link=50e9,
    ici_links=4,
    vlen_bits=8 * 128 * 32,  # one VPU vreg issue: 8x128 lanes x 32-bit
    transaction_bytes=512,
    mxu_dim=128,
)

TPU_V5P = ChipSpec(
    name="tpu-v5p",
    peak_flops={
        "bf16": 459e12,
        "fp32": 229.5e12,
        "int8": 918e12,
        "scalar": 459e12 / (128 * 128),
    },
    hbm_bw=2765e9,
    ici_bw_per_link=100e9,
    ici_links=6,
    vlen_bits=8 * 128 * 32,
    transaction_bytes=512,
    mxu_dim=128,
)

# --- The port's card: NVIDIA H100 SXM5 (data sheet; see the module doc) -----
_H100_FP32 = 67e12
_H100_FP64 = 34e12

H100 = ChipSpec(
    name="h100",
    peak_flops={
        "fp64": _H100_FP64,
        "fp32": _H100_FP32,
        "bf16": 989e12,
        "fp16": 989e12,
        "int8": 1979e12,
        # one lane of a 32-lane warp instruction
        "scalar": _H100_FP32 / 32,
        "scalar_fp64": _H100_FP64 / 32,
    },
    hbm_bw=3.35e12,
    ici_bw_per_link=900e9 / 18,
    ici_links=18,
    vlen_bits=32 * 32,  # one warp instruction: 32 lanes x 32-bit
    transaction_bytes=32,  # one L2 sector
)

DEFAULT_CHIP = TPU_V5E

CHIPS: Mapping[str, ChipSpec] = {
    "grace-core": GRACE_CORE,
    "grace-socket": GRACE_SOCKET,
    "tpu-v5e": TPU_V5E,
    "tpu-v5p": TPU_V5P,
    "h100": H100,
}


def get_chip(name: str) -> ChipSpec:
    if name not in CHIPS:
        raise KeyError(f"unknown chip {name!r}; have {sorted(CHIPS)}")
    return CHIPS[name]
