"""GEMM kernel call surface (served by the kernel registry), across from
:mod:`repro.kernels.gemm.ops`.  The reference's VMEM tile model belongs to
its autotuner, which is not ported yet (ROADMAP 1.17.3)."""

from __future__ import annotations

from repro_torch.kernels.registry import GEMM as gemm

__all__ = ["gemm"]
