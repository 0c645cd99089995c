"""Roofline-guided autotuner: prune analytically, time survivors, persist
(a port of :mod:`repro.tuning.tune`).

``tune()`` turns the paper's adapted roofline (Eq. 2) into a search pruner:
every candidate launch variant of a kernel's :class:`~repro_torch.tuning.
space.TuningSpace` is scored with ``max(flops / vector_peak, traffic /
bw)`` — the roofline lower bound read as a time — plus the shared-memory
feasibility check, and only the ``keep`` best-predicted survivors are ever
timed.  On the card (``mode="compiled"``, the default, on tensors that
``device`` puts there) a survivor is timed with CUDA events around a run of
launches after a warm-up, best of ``repeats``: a host clock around a 5 us
kernel would time its launch.  On the CPU (``mode="interpret"``, the plain
versions) the paper's profiler methodology times it
(:func:`repro_torch.core.profiler.time_fn`).  Nothing falls back from one
mode to the other: ``"compiled"`` on CPU tensors raises.  The winner is
written to the persistent tuning store as a :class:`~repro_torch.tuning.
records.TuningRecord`, so a second process tuning the same (kernel, chip,
dtype) performs **zero timing runs** — the same contract the analysis
pipeline's ArtifactStore gives recorded events.

The ELEN-packing axis (paper Eq. 1: VB = VLEN/ELEN) is the ``dtype``
argument: tuning at ``dtype="bf16"`` casts the example operands and scores
against the bf16 roofline, whose knee sits at AI_IRV = AI_IRR * VLEN/ELEN.
The default chip model is :data:`repro_torch.core.hw.H100`, the card the
port runs on.

Kernel-registry imports are deliberately lazy (function-local): the
registry attaches spaces from :mod:`repro_torch.tuning.spaces` at import time,
and a module-level import here would cycle.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import hw
from repro_torch.core.roofline import adapted_roofline
from repro_torch.tuning.records import (
    TuningRecord,
    load_record,
    resolve_store,
    save_record,
    tuning_fingerprint,
)
from repro_torch.tuning.space import (
    TuningSpace,
    canonical_dtype,
    predicted_config_time_s,
)

#: Process-wide count of candidate-timing invocations.  The cross-process
#: acceptance test asserts this stays 0 when every record is a store hit.
TIMING_RUNS = 0
_TIMING_LOCK = threading.Lock()  # tune_kernels(jobs>1) increments concurrently


def timing_runs() -> int:
    """Process-wide candidate-timing invocation count.

    Accessor rather than attribute because ``repro_torch.tuning.tune`` names the
    *function* on the package (the submodule is shadowed by the re-export).
    """
    return TIMING_RUNS

_DTYPE_TO_TORCH = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}


def _resolve_ops(kernel: Any):
    if isinstance(kernel, str):
        from repro_torch.kernels.registry import get_kernel

        return get_kernel(kernel)
    return kernel


def _example_args(ops: Any) -> Tuple:
    """Default problem: the kernel's registered ``kernel/<name>`` workload."""
    from repro_torch.analysis.workload import get_workload

    try:
        wl = get_workload(f"kernel/{ops.name}")
    except KeyError:
        raise ValueError(
            f"kernel {ops.name!r} has no registered example workload; "
            "pass args=... explicitly"
        ) from None
    return wl.example_args()


def _infer_dtype(args: Tuple) -> str:
    for a in args:
        dt = getattr(a, "dtype", None)
        if dt is not None:
            return canonical_dtype(dt)
    return "fp32"


def _cast_args(args: Tuple, dtype: str) -> Tuple:
    """Cast floating-point torch operands to the ELEN candidate (ints
    untouched)."""
    name = _DTYPE_TO_TORCH.get(dtype)
    if name is None:
        return args
    target = getattr(torch, name)
    return tuple(
        a.to(target)
        if isinstance(a, torch.Tensor) and a.is_floating_point() else a
        for a in args)


def _to_device(args: Tuple, device: Any) -> Tuple:
    """The torch operands on ``device`` (None leaves them where they are)."""
    if device is None:
        return args
    device = torch.device(device)
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _device_time_s(fn: Any, args: Tuple, kw: Dict[str, Any], *,
                   repeats: int, min_time_s: float) -> float:
    """Best-of-``repeats`` seconds of one call on the card: CUDA events
    around a run of ``n`` calls (about 10 ms, or ``min_time_s``, of them),
    queued behind a spin on the card so that the host's enqueueing stays
    out of the events, after one warm-up call."""
    fn(*args, **kw)  # warm-up: loads the library, raises the smem limit
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(*args, **kw)
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end) / 1e3, 1e-7)
    n = int(min(max(1.0, max(min_time_s, 0.01) / one), 200))
    best = float("inf")
    for _ in range(max(int(repeats), 1)):
        torch.cuda._sleep(n * 100_000)  # about 50 us a call at 2 GHz
        start.record()
        for _ in range(n):
            fn(*args, **kw)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / n)
    return best


def _time_config(
    ops: Any,
    args: Tuple,
    config: Dict[str, Any],
    *,
    fixed: Dict[str, Any],
    mode: str,
    repeats: int,
    min_time_s: float,
) -> float:
    """Best-of-repeats seconds for one candidate (warmup outside the ROI):
    ``mode="compiled"`` times ``ops.kernel`` (which raises on CPU tensors),
    ``"interpret"`` ``ops.interpret``, the plain version; with CUDA events
    on the card, with the paper's profiler on the CPU."""
    global TIMING_RUNS
    if mode not in ("compiled", "interpret"):
        raise ValueError(f"mode must be compiled|interpret, got {mode!r}")
    with _TIMING_LOCK:
        TIMING_RUNS += 1
    from repro_torch.core.profiler import time_fn

    fn = ops.kernel if mode == "compiled" else ops.interpret
    kw = {**fixed, **config}
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        return _device_time_s(fn, args, kw, repeats=repeats,
                              min_time_s=min_time_s)
    return time_fn(fn, *args, repeats=repeats, min_time_s=min_time_s, **kw)


# ---------------------------------------------------------------------------
# Analytic pruning
# ---------------------------------------------------------------------------


def prune(
    space: TuningSpace,
    args: Tuple,
    chip: hw.ChipSpec,
    dtype: str,
    *,
    keep: int = 4,
) -> Tuple[List[Tuple[Dict[str, Any], float]], int]:
    """Roofline-scored survivors: ``([(config, predicted_s), ...], pruned)``.

    Candidates are clamped/deduplicated/smem-filtered by the space, then
    stably sorted by predicted time (enumeration order breaks ties), and
    all but the first ``keep`` are pruned.  The score is monotone in
    predicted traffic and FLOPs, so pruning never discards a config the
    model considers faster than a survivor.
    """
    roofline = adapted_roofline(chip, dtype)
    cands = space.candidates(args)
    scored = [
        (cfg, predicted_config_time_s(space, cfg, args, roofline))
        for cfg in cands
    ]
    scored.sort(key=lambda cs: cs[1])  # stable: ties keep enumeration order
    survivors = scored[: max(int(keep), 1)]
    return survivors, len(cands) - len(survivors)


def _default_config(space: TuningSpace, args: Tuple) -> Dict[str, Any]:
    """The kernel's hard-coded defaults, clamped to the problem (the
    baseline every record's speedup is measured against)."""
    cfg = space.validate(dict(space.default), args)
    if cfg is not None:
        return cfg
    if space.clamp is not None:
        return dict(space.clamp(dict(space.default), args))
    return dict(space.default)


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def tune(
    kernel: Any,
    args: Optional[Tuple] = None,
    *,
    chip: hw.ChipSpec = hw.H100,
    dtype: Optional[str] = None,
    space: Optional[TuningSpace] = None,
    store: Any = "default",
    mode: str = "compiled",
    keep: int = 4,
    repeats: int = 2,
    min_time_s: float = 0.0,
    force: bool = False,
    apply: bool = True,
    device: Any = "cuda",
) -> TuningRecord:
    """Tune one kernel on one (chip, dtype); returns the (possibly cached)
    best-known :class:`TuningRecord`.

    * ``kernel`` — registry name or :class:`~repro_torch.kernels.registry.
      KernelOps`; ``args`` defaults to the kernel's example workload.
    * ``dtype`` — the ELEN axis: operands are cast, the roofline re-kneed.
    * ``store`` — ``"default"`` (persistent, ``$REPRO_ARTIFACT_DIR``-aware),
      a directory path, an ``ArtifactStore``, or ``None`` (never persist).
      On a store hit the record returns with ``cached=True`` and **no
      timing runs are performed** (pass ``force=True`` to re-tune).
    * ``apply`` — install the winning config on the KernelOps so subsequent
      calls resolve it automatically (explicit kwargs still win).
    * ``mode`` — ``"compiled"`` times the CUDA kernel (``ops.kernel``),
      ``"interpret"`` the plain version (``ops.interpret``).
    * ``device`` — where the operands go before timing (the registry's
      example arguments are made on the CPU); None leaves them as given.
    """
    ops = _resolve_ops(kernel)
    space = space or getattr(ops, "tuning_space", None)
    if space is None:
        raise ValueError(f"kernel {ops.name!r} has no TuningSpace")
    args = tuple(args) if args is not None else _example_args(ops)
    args = _to_device(args, device)
    dtype = dtype or _infer_dtype(args)
    if dtype != _infer_dtype(args):
        args = _cast_args(args, dtype)

    store_obj = resolve_store(store)
    fp = tuning_fingerprint(ops.name, ops.raw, args, chip.name, dtype, space)
    if store_obj is not None and not force:
        rec = load_record(store_obj, fp)
        if rec is not None:
            if apply:
                ops.set_tuned(rec.config, chip=chip.name, dtype=dtype)
            return rec

    survivors, pruned = prune(space, args, chip, dtype, keep=keep)
    if not survivors:
        raise ValueError(
            f"{ops.name}: no valid candidate in the tuning space for "
            f"args with shapes {[getattr(a, 'shape', None) for a in args]}"
        )
    fixed = dict(space.fixed)
    timed: List[Tuple[Dict[str, Any], float, float]] = []
    for cfg, predicted_s in survivors:
        t = _time_config(
            ops, args, cfg, fixed=fixed, mode=mode,
            repeats=repeats, min_time_s=min_time_s,
        )
        timed.append((cfg, t, predicted_s))

    roofline = adapted_roofline(chip, dtype)
    best_cfg, best_t, best_pred = min(timed, key=lambda cts: cts[1])
    default_cfg = space.validate(dict(space.default), args)
    default_timed = False
    if default_cfg is None:
        # the kernel's hard-coded default does not fit this problem (it
        # would trip the kernel's divisibility assert): the best survivor
        # doubles as the baseline — never time an invalid config
        default_cfg, default_t, default_pred = best_cfg, best_t, best_pred
    else:
        default_pred = predicted_config_time_s(space, default_cfg, args, roofline)
        default_t = None
        for cfg, t, _ in timed:
            if cfg == default_cfg:
                default_t = t
                break
        if default_t is None:
            default_timed = True
            default_t = _time_config(
                ops, args, default_cfg, fixed=fixed, mode=mode,
                repeats=repeats, min_time_s=min_time_s,
            )
        if default_t < best_t:  # never ship a config slower than the default
            best_cfg, best_t, best_pred = default_cfg, default_t, default_pred

    record = TuningRecord(
        kernel=ops.name,
        chip=chip.name,
        dtype=dtype,
        fingerprint=fp,
        config=best_cfg,
        default_config=default_cfg,
        best_time_s=best_t,
        default_time_s=default_t,
        predicted_best_s=best_pred,
        predicted_default_s=default_pred,
        space_size=space.size(),
        candidates=len(survivors) + pruned,
        pruned=pruned,
        timed=len(timed) + (1 if default_timed else 0),
        mode=mode,
        problem="x".join(
            str(tuple(getattr(a, "shape", ()))) for a in args[:2]
        ),
    )
    if store_obj is not None:
        save_record(store_obj, record)
    if apply:
        ops.set_tuned(record.config, chip=chip.name, dtype=dtype)
    return record


def load_tuned(
    kernel: Any,
    *,
    chip: hw.ChipSpec = hw.H100,
    dtype: Optional[str] = None,
    args: Optional[Tuple] = None,
    store: Any = "default",
    apply: bool = True,
) -> Optional[TuningRecord]:
    """Pick up a persisted record without ever timing (None on store miss).

    The cross-process half of the zero-re-tune story: process A ``tune()``s
    and persists; process B ``load_tuned()``s and its KernelOps resolves the
    stored config at call time.
    """
    ops = _resolve_ops(kernel)
    space = getattr(ops, "tuning_space", None)
    store_obj = resolve_store(store)
    if space is None or store_obj is None:
        return None
    args = tuple(args) if args is not None else _example_args(ops)
    dtype = dtype or _infer_dtype(args)
    if dtype != _infer_dtype(args):
        args = _cast_args(args, dtype)
    fp = tuning_fingerprint(ops.name, ops.raw, args, chip.name, dtype, space)
    rec = load_record(store_obj, fp)
    if rec is not None and apply:
        ops.set_tuned(rec.config, chip=chip.name, dtype=dtype)
    return rec


# ---------------------------------------------------------------------------
# The analyze() hook: tuned-vs-default outlook, no timing
# ---------------------------------------------------------------------------


def outlook(
    ops: Any,
    args: Tuple,
    chip: hw.ChipSpec,
    *,
    dtype: str = "fp32",
    store: Any = "default",
) -> Optional[Dict[str, Any]]:
    """Analytic tuned-vs-default report for ``SVEAnalysis.tuning``.

    Pure model + store lookup — never compiles, never times.  ``record`` is
    the persisted best config when one exists (the zero-re-tune pickup),
    else None.
    """
    space = getattr(ops, "tuning_space", None)
    if space is None:
        return None
    if dtype != _infer_dtype(args):
        # mirror tune(): the ELEN axis casts operands, and both the record
        # fingerprint and the smem/traffic models see the cast shapes
        args = _cast_args(args, dtype)
    roofline = adapted_roofline(chip, dtype)
    survivors, pruned = prune(space, args, chip, dtype, keep=1)
    if not survivors:
        return None
    best_cfg, best_pred = survivors[0]
    default_cfg = _default_config(space, args)
    default_pred = predicted_config_time_s(space, default_cfg, args, roofline)
    rec = None
    store_obj = resolve_store(store)
    if store_obj is not None:
        fp = tuning_fingerprint(ops.name, ops.raw, args, chip.name, dtype, space)
        rec = load_record(store_obj, fp)
    return {
        "kernel": ops.name,
        "chip": chip.name,
        "dtype": dtype,
        "default_config": default_cfg,
        "best_config": best_cfg,
        "predicted_default_s": default_pred,
        "predicted_best_s": best_pred,
        "predicted_speedup": (
            max(default_pred / best_pred, 1.0) if best_pred > 0 else 1.0
        ),
        "candidates": len(survivors) + pruned,
        "record": rec.config if rec is not None else None,
        "record_time_s": rec.best_time_s if rec is not None else None,
    }


# ---------------------------------------------------------------------------
# Sweeps (the --tune / CLI entry)
# ---------------------------------------------------------------------------


def tunable_kernels() -> List[str]:
    """Registry kernels with both a TuningSpace and an example workload."""
    from repro_torch.analysis.workload import list_workloads
    from repro_torch.kernels.registry import KERNELS

    workloads = set(list_workloads(tags=("kernel",)))
    return sorted(
        name
        for name, ops in KERNELS.items()
        if ops.tuning_space is not None and f"kernel/{name}" in workloads
    )


def tune_kernels(
    kernels: Optional[Sequence[str]] = None,
    *,
    chip: hw.ChipSpec = hw.H100,
    dtypes: Optional[Sequence[str]] = None,
    jobs: int = 1,
    cap: Optional[int] = None,
    store: Any = "default",
    mode: str = "compiled",
    keep: int = 4,
    repeats: int = 2,
    min_time_s: float = 0.0,
    force: bool = False,
    apply: bool = True,
    device: Any = "cuda",
) -> List[TuningRecord]:
    """Tune a set of kernels over the ELEN axis; returns records in
    deterministic (kernel, dtype) order.

    ``dtypes=None`` tunes each kernel's base dtype only; ``dtypes=()`` (or
    ``["space"]``) sweeps each space's own ELEN candidates.  ``cap`` takes
    the first N values of every axis (the CI tiny-space knob).  ``jobs``
    fans (kernel, dtype) cells over a thread pool — store hits are
    timing-free so this is safe for cached sweeps; live timing under heavy
    concurrency will show scheduler noise.
    """
    names = list(kernels) if kernels else tunable_kernels()
    cells: List[Tuple[str, TuningSpace, Optional[str]]] = []
    for name in names:
        ops = _resolve_ops(name)
        space = getattr(ops, "tuning_space", None)
        if space is None:
            raise ValueError(f"kernel {name!r} has no TuningSpace")
        if cap is not None:
            space = space.subset(cap)
        if dtypes is None:
            cell_dtypes: Sequence[Optional[str]] = (None,)
        elif len(dtypes) == 0 or list(dtypes) == ["space"]:
            cell_dtypes = space.dtypes or (None,)
        else:
            cell_dtypes = dtypes
        for dt in cell_dtypes:
            cells.append((name, space, dt))

    def run_cell(cell: Tuple[str, TuningSpace, Optional[str]]) -> TuningRecord:
        name, cell_space, dt = cell
        return tune(
            name, chip=chip, dtype=dt, space=cell_space, store=store,
            mode=mode, keep=keep, repeats=repeats, min_time_s=min_time_s,
            force=force, apply=apply, device=device,
        )

    if jobs <= 1 or len(cells) <= 1:
        return [run_cell(c) for c in cells]
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        return list(pool.map(run_cell, cells))


def report_dict(records: Sequence[TuningRecord], *, wall_s: float = 0.0) -> Dict:
    """Machine-readable ``tuning.json`` payload."""
    return {
        "kind": "tuning_report",
        "records": [r.to_dict() for r in records],
        "stats": {
            "tuned": len(records),
            "cached": sum(1 for r in records if r.cached),
            "timing_runs": TIMING_RUNS,
            "wall_s": round(wall_s, 3),
        },
    }


def format_records(records: Sequence[TuningRecord]) -> str:
    """Fixed-width table over ``TuningRecord.row()`` projections."""
    rows = [r.row() for r in records]
    if not rows:
        return "(no tuning records)"
    keys = list(rows[0].keys())
    widths = {k: max(len(k), *(len(str(r[k])) for r in rows)) for k in keys}
    lines = ["  ".join(k.ljust(widths[k]) for k in keys)]
    for r in rows:
        lines.append("  ".join(str(r[k]).ljust(widths[k]) for k in keys))
    return "\n".join(lines)
