"""Tuning search spaces: the per-kernel launch axes + the ELEN axis (a port
of :mod:`repro.tuning.space`).

A :class:`TuningSpace` declares, for one registered kernel, the keyword
arguments worth searching (in the port: the CUDA kernels' compiled launch
variants, see :mod:`repro_torch.tuning.spaces`), the dtype
candidates of the paper's ELEN-packing axis (Eq. 1: VB = VLEN/ELEN — a
smaller element type packs more lanes per issue), and the analytic models
the tuner uses to prune before ever timing anything:

* ``vmem_model``    — working-set bytes per grid step; candidates exceeding
  ``vmem_budget`` are discarded outright (they could not be scheduled).
  The field names are the reference's, so its spaces load here unchanged;
  on the card the model is a block's shared memory and the budget
  :data:`SMEM_LIMIT`, the 232,448 bytes a block of an H100 may opt into;
* ``traffic_model`` — HBM bytes as a function of the tile config (tile
  reuse: e.g. a GEMM re-streams each operand once per tile of the other);
* ``flops_model``   — config-independent FLOPs of the problem.

``traffic_model`` + ``flops_model`` feed :func:`predicted_time_s`, the
adapted roofline (paper Eq. 2) read as a time bound — the pruning score of
:func:`repro_torch.tuning.tune.tune`.

Spaces are declarative and free of registry/kernel imports, so the kernel
registry can attach one to each :class:`~repro_torch.kernels.registry.KernelOps`
at registration time without an import cycle.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

#: shared memory a block of an H100 may opt into: the budget of the port's
#: spaces
SMEM_LIMIT = 232448


@dataclasses.dataclass(frozen=True)
class TuningSpace:
    """Search space + analytic models for one kernel's static arguments.

    ``axes`` maps each tunable static kwarg to its ordered candidate values
    (the enumeration order is the deterministic tie-break).  ``fixed`` holds
    non-tuned kwargs the kernel needs at tuning time (e.g. the RX gate's
    ``qubit``/``theta``).  ``clamp`` mirrors the kernel's own ``min(block,
    dim)`` clamping so oversized candidates collapse onto their effective
    config (and dedupe); ``constraint`` rejects configs the kernel would
    raise on (in the port, a launch variant its plan function refuses).  All model callables receive the *merged*
    config (fixed + candidate + caller kwargs) and the positional example
    arguments.
    """

    kernel: str
    axes: Mapping[str, Tuple[Any, ...]]
    default: Mapping[str, Any]
    dtypes: Tuple[str, ...] = ()
    fixed: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    clamp: Optional[Callable[[Dict[str, Any], Tuple], Dict[str, Any]]] = None
    constraint: Optional[Callable[[Dict[str, Any], Tuple], bool]] = None
    vmem_model: Optional[Callable[[Dict[str, Any], Tuple, int], float]] = None
    traffic_model: Optional[Callable[[Dict[str, Any], Tuple], float]] = None
    flops_model: Optional[Callable[[Tuple], float]] = None
    vmem_budget: int = SMEM_LIMIT

    # -- enumeration ---------------------------------------------------------

    def size(self) -> int:
        """Cartesian-product size of the raw (unclamped) space."""
        n = 1
        for values in self.axes.values():
            n *= max(len(values), 1)
        return max(n, 1) * max(len(self.dtypes), 1)

    def configs(self) -> List[Dict[str, Any]]:
        """Every axis combination, in axis-declaration order (bm outermost
        for GEMM — the legacy search-loop order, kept as the tie-break)."""
        keys = list(self.axes)
        if not keys:
            return [{}]
        return [
            dict(zip(keys, values))
            for values in itertools.product(*(self.axes[k] for k in keys))
        ]

    def validate(
        self,
        config: Mapping[str, Any],
        args: Tuple,
        *,
        dtype_bytes: Optional[int] = None,
        extra: Optional[Mapping[str, Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Clamp ``config`` to ``args`` and check constraint + VMEM budget.

        Returns the clamped axis-config, or ``None`` if the kernel would
        reject it (failed divisibility) or it cannot fit the VMEM budget.
        ``extra`` carries caller kwargs (they override ``fixed`` in the
        merged view the models see, mirroring a real call).
        """
        cfg = {k: config[k] for k in self.axes if k in config}
        if self.clamp is not None:
            cfg = dict(self.clamp(dict(cfg), args))
        merged = {**self.fixed, **(extra or {}), **cfg}
        if self.constraint is not None and not self.constraint(merged, args):
            return None
        if self.vmem_model is not None:
            if dtype_bytes is None:
                dtype_bytes = _dtype_bytes_of(args)
            if self.vmem_model(merged, args, dtype_bytes) > self.vmem_budget:
                return None
        return cfg

    def candidates(
        self, args: Tuple, *, dtype_bytes: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """Valid clamped configs, deduplicated, in enumeration order."""
        if dtype_bytes is None:
            dtype_bytes = _dtype_bytes_of(args)
        out: List[Dict[str, Any]] = []
        seen = set()
        for raw in self.configs():
            cfg = self.validate(raw, args, dtype_bytes=dtype_bytes)
            if cfg is None:
                continue
            key = tuple(sorted(cfg.items()))
            if key in seen:
                continue
            seen.add(key)
            out.append(cfg)
        return out

    def subset(self, cap: int) -> "TuningSpace":
        """Space with at most ``cap`` values per axis — the CI "tiny space"
        knob (values keep their order, so the preferred candidates stay)."""
        cap = max(int(cap), 1)
        return dataclasses.replace(
            self,
            axes={k: tuple(v[:cap]) for k, v in self.axes.items()},
            dtypes=tuple(self.dtypes[:cap]),
        )

    # -- identity ------------------------------------------------------------

    def token(self) -> str:
        """Stable content token for fingerprints: the declarative parts of
        the space (axes/defaults/dtypes/fixed/budget).  Model callables are
        deliberately excluded — refining an analytic model reorders pruning
        but does not invalidate a timed record."""
        axes = ",".join(f"{k}={tuple(v)!r}" for k, v in self.axes.items())
        fixed = ",".join(f"{k}={v!r}" for k, v in sorted(self.fixed.items()))
        default = ",".join(f"{k}={v!r}" for k, v in sorted(self.default.items()))
        return (
            f"{self.kernel}|axes[{axes}]|default[{default}]|"
            f"dtypes{tuple(self.dtypes)!r}|fixed[{fixed}]|vmem{self.vmem_budget}"
        )


#: Canonical ELEN names for concrete array dtypes (shared by the tuner and
#: the registry's call-time config resolution).
CANONICAL_DTYPE = {
    "float32": "fp32", "float16": "fp16", "bfloat16": "bf16",
    "float64": "fp64", "int8": "int8", "int32": "int32",
}


def canonical_dtype(dtype: Any) -> str:
    """Paper-style ELEN name ("fp32", "bf16", ...) for an array dtype: a
    torch dtype (``str(torch.float32)`` is "torch.float32") or a numpy
    one."""
    key = str(dtype).removeprefix("torch.")
    return CANONICAL_DTYPE.get(key, key)


def _dtype_bytes_of(args: Sequence[Any], default: int = 4) -> int:
    """Element size of the first shaped argument (the tile-footprint unit)."""
    for a in args:
        dt = getattr(a, "dtype", None)
        if dt is not None and hasattr(dt, "itemsize"):
            return int(dt.itemsize)
    return default


def predicted_time_s(flops: float, hbm_bytes: float, roofline: Any) -> float:
    """Adapted-roofline (Eq. 2) lower bound read as a time:
    ``max(flops / vector_peak, bytes / bw)``.

    Monotone in both inputs — a candidate that moves more HBM bytes (or
    more FLOPs) is never predicted faster, which is what makes it safe as a
    pruning score (see ``test_torch_tuning.py::test_pruning_monotone``).
    """
    compute_s = flops / max(roofline.vector_peak, 1e-30)
    memory_s = hbm_bytes / max(roofline.bw, 1e-30)
    return max(compute_s, memory_s)


def predicted_config_time_s(
    space: TuningSpace,
    config: Mapping[str, Any],
    args: Tuple,
    roofline: Any,
) -> float:
    """Roofline-predicted time of one candidate config.

    Uses the space's traffic/flops models where present; with neither, all
    candidates score identically and the enumeration order decides (the
    tuner then falls back to timing alone).
    """
    merged = {**space.fixed, **config}
    flops = space.flops_model(args) if space.flops_model is not None else 0.0
    traffic = (
        space.traffic_model(merged, args)
        if space.traffic_model is not None
        else 0.0
    )
    return predicted_time_s(flops, traffic, roofline)
