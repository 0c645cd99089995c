"""Kernel registry: the paper's Sec. 3.2 micro-benchmark suite behind one
registration surface, across from :mod:`repro.kernels.registry`.

:func:`register_kernel` returns a :class:`KernelOps` exposing the call
surfaces:

* ``op(*args)``           — the CUDA kernel for CUDA tensors, the plain
  PyTorch version for CPU tensors (the kernel module's wrapper);
* ``op.kernel(*args)``    — the CUDA kernel; raises on CPU tensors;
* ``op.interpret(*args)`` — the plain PyTorch version, on the tensors'
  device;
* ``op.ref(*args)``       — the oracle.

There is no fallback from one surface to another.  Registration also
registers the kernel's example :class:`~repro_torch.analysis.workload.
Workload` (``kernel/<name>``), at the reference's problem size with its
analytic flops/bytes model, so ``repro_torch.analysis.analyze`` reaches
every kernel.  Example arguments come from a seeded ``torch.Generator`` on
the CPU; ``analyze(..., time_roi=True)`` moves them to the card.

The reference's autotuner state (tuned configs, tuning spaces) is not
ported yet (ROADMAP 1.17).  The tile keywords (``bm/bn/bk``,
``block_rows``) are checked as the reference checks them, so the same
calls fail, but each CUDA kernel's tile is its own: mapping tiling axes to
CUDA launch configurations is the tuning port's job.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.analysis.workload import Workload, register_lazy
from repro_torch.kernels.gemm import kernel as _gemm_k, ref as _gemm_r
from repro_torch.kernels.jacobi2d import kernel as _jac_k, ref as _jac_r
from repro_torch.kernels.spmv import kernel as _spmv_k, ref as _spmv_r
from repro_torch.kernels.stream import kernel as _stream_k, ref as _stream_r


class KernelOps:
    """Call surface for one registered kernel (wrapper / kernel / plain /
    ref)."""

    def __init__(self, name: str, kernel_fn: Callable, plain_fn: Callable,
                 ref_fn: Optional[Callable] = None) -> None:
        self.name = name
        self.raw = kernel_fn
        self._plain = plain_fn
        self._ref = ref_fn
        functools.update_wrapper(self, kernel_fn, updated=())

    def __call__(self, *args: Any, **kw: Any):
        return self.raw(*args, **kw)

    def kernel(self, *args: Any, **kw: Any):
        cpu = [a for a in args if isinstance(a, torch.Tensor) and not a.is_cuda]
        if cpu:
            raise ValueError(
                f"{self.name}.kernel runs the CUDA kernel and needs CUDA "
                f"tensors, got {cpu[0].device}; .interpret is the plain "
                f"version")
        return self.raw(*args, **kw)

    def interpret(self, *args: Any, **kw: Any):
        return self._plain(*args, **kw)

    def ref(self, *args: Any, **kw: Any):
        if self._ref is None:
            raise NotImplementedError(f"kernel {self.name!r} has no ref oracle")
        return self._ref(*args, **kw)

    def __repr__(self) -> str:
        return f"KernelOps({self.name!r})"


KERNELS: Dict[str, KernelOps] = {}

# kernel workload builders, kept so registration can be re-applied after
# repro_torch.analysis.clear_registry() (import side effects run once)
_WORKLOAD_BUILDERS: Dict[str, Callable[[], Workload]] = {}


def register_builtin_workloads() -> None:
    """(Re-)register every kernel workload; idempotent discovery hook."""
    for wl_name, builder in _WORKLOAD_BUILDERS.items():
        register_lazy(wl_name, builder, tags=("kernel",), replace=True)


def register_kernel(
    name: str,
    kernel: Callable,
    *,
    plain: Callable,
    ref: Optional[Callable] = None,
    workload: Optional[Callable[[], Workload]] = None,
) -> KernelOps:
    """Register a kernel entry point.

    ``kernel`` is the wrapper (CUDA kernel on the card, plain version on the
    CPU), ``plain`` the plain version with the same signature, ``workload``
    a zero-arg builder of the kernel's example Workload, registered lazily
    as ``kernel/<name>``.
    """
    if name in KERNELS:
        raise ValueError(f"kernel {name!r} already registered")
    ops = KernelOps(name, kernel, plain, ref)
    KERNELS[name] = ops
    if workload is not None:
        _WORKLOAD_BUILDERS[f"kernel/{name}"] = workload
        register_lazy(f"kernel/{name}", workload, tags=("kernel",),
                      replace=True)
    return ops


def get_kernel(name: str) -> KernelOps:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    return KERNELS[name]


def list_kernels() -> list:
    return sorted(KERNELS)


# ---------------------------------------------------------------------------
# The ported kernel packages
# ---------------------------------------------------------------------------


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _gemm_workload() -> Workload:
    n = 256
    fb = _gemm_r.flops_bytes(n, n, n, 4)

    def args():
        x = torch.randn((n, n), generator=_generator(0))
        y = torch.randn((n, n), generator=_generator(1))
        return (x, y)

    return Workload(
        name="kernel/gemm", fn=GEMM, args=args, dtype="fp32",
        flops=fb["flops"], hbm_bytes=fb["bytes"],
        problem=f"{n}^2", tags=("kernel",),
        notes="tiled CUDA-core GEMM; compute-bound Class 4",
    )


def _stream_workload() -> Workload:
    rows, cols = 2048, 128
    fb = _stream_r.flops_bytes("triad", rows * cols, 4)

    def args():
        a = torch.ones((rows, cols))
        b = torch.ones((rows, cols))
        return (a, b, 3.0)

    return Workload(
        name="kernel/stream-triad", fn=STREAM_TRIAD, args=args, dtype="fp32",
        flops=fb["flops"], hbm_bytes=fb["bytes"],
        problem=f"{rows}x{cols}", tags=("kernel",),
        notes="McCalpin triad; streaming memory-bandwidth-bound Class 2",
    )


def _spmv_workload() -> Workload:
    n = 512
    vals, cols, nnz = _spmv_r.make_problem(
        n, n, row_block=8, max_nnz=64, width_pad=128,
        generator=_generator(0))
    x = torch.randn((n,), generator=_generator(1))
    # per-nnz accounting (same model as spmv/ops.flops_bytes): 2 FLOPs per
    # nonzero; traffic = val + colidx + gathered x, the x reads being the
    # latency-bound pointer-chasing share
    total_nnz = float(nnz.sum())
    return Workload(
        name="kernel/spmv", fn=SPMV, args=(vals, cols, nnz, x), dtype="fp32",
        flops=2.0 * total_nnz, hbm_bytes=total_nnz * (4 + 4 + 4),
        gather_bytes=total_nnz * 4,
        problem=f"{n}^2 zipf", tags=("kernel",),
        notes="predicated block-ELL SpMV; pointer-chasing Class 3",
    )


def _jacobi_workload() -> Workload:
    n = 256
    fb = _jac_r.flops_bytes(n, n, 4)

    def args():
        return (torch.randn((n, n), generator=_generator(0)),)

    return Workload(
        name="kernel/jacobi2d", fn=JACOBI_STEP, args=args, dtype="fp32",
        flops=fb["flops"], hbm_bytes=fb["bytes"],
        problem=f"{n}^2", tags=("kernel",),
        notes="5-point stencil sweep; memory-bound Class 2",
    )


GEMM = register_kernel(
    "gemm", _gemm_k.gemm, plain=_gemm_k.gemm_plain, ref=_gemm_r.gemm_ref,
    workload=_gemm_workload,
)

STREAM_COPY = register_kernel(
    "stream-copy", _stream_k.stream_copy, plain=_stream_k.stream_copy_plain,
    ref=_stream_r.copy_ref,
)
STREAM_SCALE = register_kernel(
    "stream-scale", _stream_k.stream_scale,
    plain=_stream_k.stream_scale_plain, ref=_stream_r.scale_ref,
)
STREAM_ADD = register_kernel(
    "stream-add", _stream_k.stream_add, plain=_stream_k.stream_add_plain,
    ref=_stream_r.add_ref,
)
STREAM_TRIAD = register_kernel(
    "stream-triad", _stream_k.stream_triad,
    plain=_stream_k.stream_triad_plain, ref=_stream_r.triad_ref,
    workload=_stream_workload,
)

SPMV = register_kernel(
    "spmv", _spmv_k.spmv_blockell, plain=_spmv_k.spmv_blockell_plain,
    ref=_spmv_r.spmv_ref, workload=_spmv_workload,
)
SPMV_FIXED = register_kernel(
    "spmv-fixed-width", _spmv_k.spmv_fixed_width,
    plain=_spmv_k.spmv_fixed_width_plain, ref=_spmv_r.spmv_ref,
)

JACOBI_STEP = register_kernel(
    "jacobi2d", _jac_k.jacobi_step, plain=_jac_k.jacobi_step_plain,
    ref=_jac_r.jacobi_ref, workload=_jacobi_workload,
)
