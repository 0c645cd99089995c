"""The unified workload description + global registry (paper Sec. 3.2/3.3),
a copy of :mod:`repro.analysis.workload` for PyTorch.

A :class:`Workload` is the single currency of the analysis pipeline: a
callable with example arguments, the dominant element type (the paper's
ELEN, the denominator of Eq. 1's VB = VLEN/ELEN), and an analytic
flops/bytes/gather-bytes model of the kind the paper builds per
application (Sec. 3.3).

Registration is either eager::

    from repro_torch.analysis import workload

    @workload(name="saxpy", dtype="fp32", flops=2048.0, hbm_bytes=12288.0,
              args=lambda: (torch.ones(1024), torch.ones(1024)))
    def saxpy(x, y):
        return x + 2.0 * y

or lazy (``register_lazy``), which defers building example arguments until
the workload is requested — how the kernel registry registers itself.
Discovery finds the port's kernel registry; the reference's 13 paper
applications (``benchmarks/apps.py``) are not ported yet (ROADMAP 1.17.4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import hw, metrics


@dataclasses.dataclass
class Workload:
    """One analyzable unit of work: callable + example args + cost model.

    ``args`` may be the literal argument tuple or a zero-argument thunk
    returning it (resolved once, on first use).  The analytic model fields
    (``flops`` / ``hbm_bytes`` / ``gather_bytes``) are optional: a
    workload without them is analysed from a recording of one run of
    ``fn`` (the compiled source, :mod:`repro_torch.core.op_cost`).
    """

    name: str
    fn: Optional[Callable] = None
    args: Any = ()
    dtype: str = "fp32"  # dominant ELEN (paper semantics)
    # -- optional analytic cost model (paper Sec. 3.3 style) ---------------
    flops: Optional[float] = None
    hbm_bytes: Optional[float] = None
    gather_bytes: float = 0.0
    vectorizable_fraction: float = 1.0
    collective_bytes: float = 0.0
    n_devices: int = 1
    # -- bookkeeping -------------------------------------------------------
    problem: str = ""  # reduced problem run here
    full_problem: str = ""  # the paper's problem size
    tags: Tuple[str, ...] = ()
    notes: str = ""
    _resolved_args: Optional[Tuple[Any, ...]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _device_args: Dict[str, Tuple[Any, ...]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def example_args(self) -> Tuple[Any, ...]:
        """The example argument tuple, resolving a lazy thunk once."""
        if self._resolved_args is None:
            a = self.args
            if callable(a):
                a = a()
            self._resolved_args = tuple(a)
        return self._resolved_args

    def args_on(self, device: torch.device) -> Tuple[Any, ...]:
        """The example arguments with every tensor moved to ``device``,
        moved once and kept (tensors already there are not copied)."""
        key = str(device)
        if key not in self._device_args:
            self._device_args[key] = tuple(
                a.to(device) if isinstance(a, torch.Tensor) else a
                for a in self.example_args())
        return self._device_args[key]

    @property
    def has_analytic_model(self) -> bool:
        return self.flops is not None and self.hbm_bytes is not None

    @property
    def ai(self) -> float:
        """Analytic arithmetic intensity (requires the analytic model)."""
        if not self.has_analytic_model:
            raise ValueError(f"{self.name}: no analytic flops/bytes model")
        return self.flops / max(self.hbm_bytes, 1e-30)

    def issue_model(
        self, chip: hw.ChipSpec = hw.GRACE_CORE, *, dtype: Optional[str] = None
    ) -> Dict[str, float]:
        """Scalar vs vector issue counts at this workload's ELEN (Eq. 1).

        ``dtype`` overrides the workload's own ELEN (the paper's
        fixed-VLEN / varying-ELEN sweep)."""
        dtype = dtype or self.dtype
        elements = (self.flops or 0.0) / 2.0  # FMA-equivalent elements
        vec = metrics.vector_issues(elements, dtype, chip)
        scalar = metrics.scalar_issues(elements)
        # Amdahl over the vectorizable fraction (paper Sec. 4.1)
        vb = metrics.vectorization_bound(chip, dtype)
        r_eff = metrics.amdahl_r_ins(vb, self.vectorizable_fraction)
        return {"scalar": scalar, "vector": vec, "r_ins": r_eff, "vb": vb}

    def report(
        self, chip: hw.ChipSpec = hw.GRACE_CORE, *, dtype: Optional[str] = None
    ) -> metrics.VectorizationReport:
        """VectorizationReport from the analytic model (paper Sec. 3.3)."""
        if not self.has_analytic_model:
            raise ValueError(f"{self.name}: no analytic flops/bytes model")
        dtype = dtype or self.dtype
        ins = self.issue_model(chip, dtype=dtype)
        return metrics.VectorizationReport(
            name=self.name,
            dtype=dtype,
            flops=self.flops,
            hbm_bytes=self.hbm_bytes,
            gather_bytes=self.gather_bytes,
            ins_scalar=ins["scalar"],
            ins_vec=ins["scalar"] / ins["r_ins"],
            vectorizable_fraction=self.vectorizable_fraction,
            collective_bytes=self.collective_bytes,
        )


# ---------------------------------------------------------------------------
# Global registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Workload] = {}
# name -> (builder, tags); tags are kept registry-side so tag filtering
# never has to materialize a lazy workload
_LAZY: Dict[str, Tuple[Callable[[], Workload], Tuple[str, ...]]] = {}
_discovered = False


def _discover() -> None:
    """(Re-)register the built-in workload providers.

    The provider is the port's kernel registry.  It exposes an idempotent
    registration hook (module import alone is not enough: after
    ``clear_registry`` the module is still cached in ``sys.modules``, so
    its import-time side effects would never re-run).
    """
    global _discovered
    if _discovered:
        return
    _discovered = True
    import repro_torch.kernels.registry as _kreg

    _kreg.register_builtin_workloads()


def register(wl: Workload, *, name: Optional[str] = None, replace: bool = False) -> Workload:
    """Register a Workload under ``name`` (default: ``wl.name``)."""
    key = name or wl.name
    if not replace and (key in _REGISTRY or key in _LAZY):
        raise ValueError(f"workload {key!r} already registered")
    _LAZY.pop(key, None)
    _REGISTRY[key] = wl
    return wl


def register_lazy(
    name: str,
    builder: Callable[[], Workload],
    *,
    tags: Tuple[str, ...] = (),
    replace: bool = False,
) -> None:
    """Register ``builder`` to be called on first ``get_workload(name)``.

    ``tags`` are stored registry-side so ``list_workloads(tags=...)`` can
    filter without building the workload.
    """
    if not replace and (name in _REGISTRY or name in _LAZY):
        raise ValueError(f"workload {name!r} already registered")
    _REGISTRY.pop(name, None)
    _LAZY[name] = (builder, tuple(tags))


def get_workload(name: str) -> Workload:
    """Resolve a registered workload by name, materializing lazy entries."""
    _discover()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _LAZY:
        builder, tags = _LAZY.pop(name)
        wl = builder()
        if tags and not wl.tags:
            wl.tags = tags
        _REGISTRY[name] = wl
        return wl
    raise KeyError(
        f"unknown workload {name!r}; registered: {sorted(set(_REGISTRY) | set(_LAZY))}"
    )


def list_workloads(*, tags: Optional[Tuple[str, ...]] = None) -> List[str]:
    """Names of every registered workload (lazy entries included, unbuilt)."""
    _discover()
    if not tags:
        return sorted(set(_REGISTRY) | set(_LAZY))
    out = []
    for n, wl in _REGISTRY.items():
        if any(t in wl.tags for t in tags):
            out.append(n)
    for n, (_, lazy_tags) in _LAZY.items():
        if any(t in lazy_tags for t in tags):
            out.append(n)
    return sorted(out)


def clear_registry() -> None:
    """Drop every registration (test isolation only)."""
    global _discovered
    _REGISTRY.clear()
    _LAZY.clear()
    _discovered = False


def workload(
    name: Optional[str] = None,
    *,
    args: Any = (),
    dtype: str = "fp32",
    replace: bool = False,
    **fields: Any,
) -> Callable[[Callable], Callable]:
    """Decorator: register the decorated callable as a Workload.

    The function itself is returned unchanged; the registered Workload is
    attached as ``fn.__workload__``.  Extra keyword fields (``flops``,
    ``hbm_bytes``, ``gather_bytes``, ``problem``, ``tags``, ...) pass
    through to the Workload constructor.
    """

    def deco(fn: Callable) -> Callable:
        wl = Workload(
            name=name or fn.__name__, fn=fn, args=args, dtype=dtype, **fields
        )
        register(wl, replace=replace)
        fn.__workload__ = wl
        return fn

    return deco
