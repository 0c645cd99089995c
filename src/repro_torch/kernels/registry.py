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
the CPU; ``analyze(..., time_roi=True)`` moves them to the card, and
``analyze(..., source="compiled")`` records the plain version on CPU
copies of them.

The TPU tile keywords (``bm/bn/bk``, ``block_rows``, ``block_outer``,
``block_s``, ``block_c``) are checked as the reference checks them, so the
same calls fail; each CUDA kernel's launch shape is its own, named by the
keywords of its compiled launch variants.  A kernel registered with a
:class:`~repro_torch.tuning.space.TuningSpace` over those keywords
(:mod:`repro_torch.tuning.spaces`; SpMV has none, as in the reference) is
reachable by the roofline-guided autotuner (``repro_torch.tuning``): after
a ``tune()`` or ``load_tuned()`` the ops object resolves its best-known
config on ``__call__``, ``.kernel`` and ``.interpret``, explicit keywords
always winning.  A tuned config resolves only through these surfaces: the
serve engine calls ``flash_decode_paged``, ``flash_prefill_paged`` and
``flash_decode`` directly, so tuning never changes a serve step.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.analysis.workload import Workload, register_lazy
from repro_torch.kernels.flash_decode import kernel as _fd_k, ref as _fd_r
from repro_torch.kernels.gemm import kernel as _gemm_k, ref as _gemm_r
from repro_torch.kernels.jacobi2d import kernel as _jac_k, ref as _jac_r
from repro_torch.kernels.qc_gate import kernel as _qc_k, ref as _qc_r
from repro_torch.kernels.spmv import kernel as _spmv_k, ref as _spmv_r
from repro_torch.kernels.stream import kernel as _stream_k, ref as _stream_r
from repro_torch.tuning import spaces as _spaces
from repro_torch.tuning.space import TuningSpace, canonical_dtype


class KernelOps:
    """Call surface for one registered kernel (wrapper / kernel / plain /
    ref).

    When a :class:`TuningSpace` is attached and a tuned config is active
    (installed by ``repro_torch.tuning.tune``/``load_tuned``), calls
    resolve the tuned keywords automatically: the config is validated
    against the actual call arguments (clamp + the plan functions'
    constraint) and merged only for keywords the caller did not pass —
    explicit kwargs always win.
    """

    def __init__(self, name: str, kernel_fn: Callable, plain_fn: Callable,
                 ref_fn: Optional[Callable] = None, *,
                 tuning_space: Optional[TuningSpace] = None) -> None:
        self.name = name
        self.raw = kernel_fn
        self._plain = plain_fn
        self._ref = ref_fn
        self.tuning_space = tuning_space
        self._tuned: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._active: Optional[Tuple[str, str]] = None
        functools.update_wrapper(self, kernel_fn, updated=())

    # -- tuned-config state --------------------------------------------------

    def set_tuned(
        self,
        config: Dict[str, Any],
        *,
        chip: str = "",
        dtype: str = "",
        activate: bool = True,
    ) -> None:
        """Install a best-known config for (chip, dtype); ``activate`` makes
        it the one calls resolve (most-recent-tune-wins semantics)."""
        key = (chip, dtype)
        self._tuned[key] = dict(config)
        if activate:
            self._active = key

    def tuned_config(
        self, chip: Optional[str] = None, dtype: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        """The active tuned config (no args), or the one for (chip, dtype)."""
        if chip is None and dtype is None:
            if self._active is None:
                return None
            return dict(self._tuned[self._active])
        cfg = self._tuned.get((chip or "", dtype or ""))
        return dict(cfg) if cfg is not None else None

    def clear_tuned(self) -> None:
        self._tuned.clear()
        self._active = None

    def load_tuned(self, **kw: Any):
        """Pick up a persisted TuningRecord for this kernel (zero timing);
        see :func:`repro_torch.tuning.load_tuned` for the keyword surface."""
        from repro_torch.tuning import load_tuned

        return load_tuned(self, **kw)

    @property
    def fingerprint_extra(self) -> str:
        """Behavioral state the artifact fingerprint must see: an active
        tuned config changes what a call launches."""
        if self._active is None:
            return ""
        cfg = self._tuned.get(self._active)
        return f"tuned:{sorted(cfg.items())!r}" if cfg else ""

    def _resolve_active(self, args: Tuple) -> Optional[Dict[str, Any]]:
        """The config to resolve for THIS call: prefer the entry tuned for
        the call's element type (a multi-dtype sweep leaves one config per
        dtype), falling back to the most recently activated one."""
        if self._active is None:
            return None
        chip, _ = self._active
        for a in args:
            dt = getattr(a, "dtype", None)
            if dt is not None:
                cfg = self._tuned.get((chip, canonical_dtype(dt)))
                if cfg is not None:
                    return cfg
                break
        return self._tuned.get(self._active)

    def _tuned_kwargs(self, args: Tuple, kw: Dict[str, Any]) -> Dict[str, Any]:
        """Merge the active tuned config into ``kw`` for keys the caller
        did not pass, after re-validating it against these arguments.

        Validation sees the call as it would actually execute: caller-passed
        axis values override the tuned ones (explicit kwargs win), and only
        the surviving tuned keys are merged; a config that does not fit the
        call (another route's GEMM variant, say) is dropped whole.
        """
        cfg = self._resolve_active(args)
        if not cfg:
            return kw
        space = self.tuning_space
        if space is not None:
            view = {**cfg, **{k: v for k, v in kw.items() if k in space.axes}}
            extra = {k: v for k, v in kw.items() if k not in space.axes}
            try:
                valid = space.validate(view, args, extra=extra)
            except Exception:
                valid = None
            if valid is None:  # the call's config does not fit: fall back
                return kw
            cfg = valid
        for k, v in cfg.items():
            kw.setdefault(k, v)
        return kw

    # -- call surfaces -------------------------------------------------------

    def __call__(self, *args: Any, **kw: Any):
        return self.raw(*args, **self._tuned_kwargs(args, kw))

    def kernel(self, *args: Any, **kw: Any):
        cpu = [a for a in args if isinstance(a, torch.Tensor) and not a.is_cuda]
        if cpu:
            raise ValueError(
                f"{self.name}.kernel runs the CUDA kernel and needs CUDA "
                f"tensors, got {cpu[0].device}; .interpret is the plain "
                f"version")
        return self.raw(*args, **self._tuned_kwargs(args, kw))

    def interpret(self, *args: Any, **kw: Any):
        return self._plain(*args, **self._tuned_kwargs(args, kw))

    def ref(self, *args: Any, **kw: Any):
        if self._ref is None:
            raise NotImplementedError(f"kernel {self.name!r} has no ref oracle")
        return self._ref(*args, **kw)

    def __repr__(self) -> str:
        if self._active is not None and self._tuned.get(self._active):
            chip, dtype = self._active
            cfg = " ".join(
                f"{k}={v}" for k, v in sorted(self._tuned[self._active].items())
            )
            where = f" @ {chip}/{dtype}" if (chip or dtype) else ""
            return f"KernelOps({self.name!r}, tuned[{cfg}]{where})"
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
    tuning_space: Optional[TuningSpace] = None,
) -> KernelOps:
    """Register a kernel entry point.

    ``kernel`` is the wrapper (CUDA kernel on the card, plain version on the
    CPU), ``plain`` the plain version with the same signature, ``workload``
    a zero-arg builder of the kernel's example Workload, registered lazily
    as ``kernel/<name>``, ``tuning_space`` the keywords of its launch
    variants for ``repro_torch.tuning``.
    """
    if name in KERNELS:
        raise ValueError(f"kernel {name!r} already registered")
    ops = KernelOps(name, kernel, plain, ref, tuning_space=tuning_space)
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


def _qc_workload() -> Workload:
    n_qubits = 14
    fb = _qc_r.flops_bytes(n_qubits, 4)

    def args():
        n_amp = 1 << n_qubits
        re = torch.zeros((n_amp,))
        re[0] = 1.0
        return (re, torch.zeros((n_amp,)))

    def one_gate(re, im):
        return RX_GATE(re, im, qubit=0, theta=0.25)

    return Workload(
        name="kernel/qc-gate", fn=one_gate, args=args, dtype="fp32",
        flops=fb["flops"], hbm_bytes=fb["bytes"],
        problem=f"{n_qubits} qubits", tags=("kernel",),
        notes="single RX gate over the state vector; streaming Class 2",
    )


def _flash_prefill_workload() -> Workload:
    B, C, KV, G, D = 2, 16, 2, 4, 16
    bs, nb = 8, 8  # 64-token view per slot
    q_start = (24, 0)
    fb = _fd_r.prefill_flops_bytes(B, C, KV, G, D, q_start, dtype_bytes=4)

    def args():
        n_blocks = 1 + B * nb
        q = torch.randn((B, C, KV, G, D), generator=_generator(0))
        kn = torch.randn((B, C, KV, D), generator=_generator(1))
        vn = torch.randn((B, C, KV, D), generator=_generator(2))
        kp = torch.randn((n_blocks, bs, KV, D), generator=_generator(3))
        vp = torch.randn((n_blocks, bs, KV, D), generator=_generator(4))
        bt = 1 + torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
        return (q, kn, vn, kp, vp, bt, torch.tensor(q_start,
                                                     dtype=torch.int32))

    def one_chunk(q, kn, vn, kp, vp, bt, qs):
        return FLASH_PREFILL(q, kn, vn, kp, vp, bt, qs, block_c=8)[0]

    return Workload(
        name="kernel/flash-prefill", fn=one_chunk, args=args, dtype="fp32",
        flops=fb["flops"], hbm_bytes=fb["bytes"],
        problem=f"B{B} C{C} KV{KV} G{G} D{D} bs{bs}", tags=("kernel",),
        notes="chunked causal prefill committing K/V into paged blocks",
    )


def _flash_decode_workload() -> Workload:
    B, KV, G, D, S = 2, 2, 4, 16, 64
    valid = (40, 64)
    fb = _fd_r.flops_bytes(B, KV, G, D, valid, dtype_bytes=4)

    def args():
        q = torch.randn((B, KV, G, D), generator=_generator(0))
        k = torch.randn((B, S, KV, D), generator=_generator(1))
        v = torch.randn((B, S, KV, D), generator=_generator(2))
        return (q, k, v, torch.tensor(valid, dtype=torch.int32))

    def one_step(q, k, v, vl):
        return FLASH_DECODE(q, k, v, vl, block_s=16)

    return Workload(
        name="kernel/flash-decode", fn=one_step, args=args, dtype="fp32",
        flops=fb["flops"], hbm_bytes=fb["bytes"],
        problem=f"B{B} KV{KV} G{G} D{D} S{S}", tags=("kernel",),
        notes="predicated KV-cache attention decode; GQA reuse lifts AI",
    )


GEMM = register_kernel(
    "gemm", _gemm_k.gemm, plain=_gemm_k.gemm_plain, ref=_gemm_r.gemm_ref,
    workload=_gemm_workload, tuning_space=_spaces.gemm_space(),
)

STREAM_COPY = register_kernel(
    "stream-copy", _stream_k.stream_copy, plain=_stream_k.stream_copy_plain,
    ref=_stream_r.copy_ref,
    tuning_space=_spaces.stream_space(n_arrays=1, flops_per_elem=0.0),
)
STREAM_SCALE = register_kernel(
    "stream-scale", _stream_k.stream_scale,
    plain=_stream_k.stream_scale_plain, ref=_stream_r.scale_ref,
    tuning_space=_spaces.stream_space(n_arrays=1, flops_per_elem=1.0),
)
STREAM_ADD = register_kernel(
    "stream-add", _stream_k.stream_add, plain=_stream_k.stream_add_plain,
    ref=_stream_r.add_ref,
    tuning_space=_spaces.stream_space(n_arrays=2, flops_per_elem=1.0),
)
STREAM_TRIAD = register_kernel(
    "stream-triad", _stream_k.stream_triad,
    plain=_stream_k.stream_triad_plain, ref=_stream_r.triad_ref,
    workload=_stream_workload,
    tuning_space=_spaces.stream_space(n_arrays=2, flops_per_elem=2.0),
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
    tuning_space=_spaces.jacobi2d_space(),
)

RX_GATE = register_kernel(
    "qc-gate", _qc_k.rx_gate, plain=_qc_k.rx_gate_plain,
    workload=_qc_workload, tuning_space=_spaces.qc_gate_space(),
)

FLASH_DECODE = register_kernel(
    "flash-decode", _fd_k.flash_decode, plain=_fd_k.flash_decode_plain,
    ref=_fd_r.decode_ref, workload=_flash_decode_workload,
    tuning_space=_spaces.flash_decode_space(),
)

FLASH_PREFILL = register_kernel(
    "flash-prefill", _fd_k.flash_prefill, plain=_fd_k.flash_prefill_plain,
    ref=_fd_r.prefill_paged_ref, workload=_flash_prefill_workload,
    tuning_space=_spaces.flash_prefill_space(),
)
