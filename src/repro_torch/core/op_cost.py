"""Structural cost model over a recording of dispatched aten operations,
across from :mod:`repro.core.hlo_cost`.

The reference compiles a workload with XLA and walks the post-optimization
HLO text.  PyTorch has no such artifact that every machine can build, so
the port's "compiled artifact" is a :class:`Recording`: one entry per aten
overload that one run of the workload's callable dispatches, with its
operands' and outputs' shapes and dtypes (no tensor is kept).  The cost
walk applies ``hlo_cost.py``'s rules (``:302-415``) to that recording,
rule for rule (:data:`RULES`).

Where and how the recording is taken (:func:`record`):

* **On the CPU, on copies of the example arguments, under
  ``torch.no_grad()``.**  The events are chip-independent global
  quantities, as the reference's are.  On CPU tensors every kernel wrapper
  takes its plain version, as the reference's CPU compile lowers
  interpret-mode Pallas, so the record is the same on every machine.  A
  recording on the card would miss every hand-written kernel: the
  wrappers launch through ``ctypes`` (``kernels/build.py``), which no
  dispatch mode sees.  The ROI timing (``analyze(time_roi=True)``) is
  what runs on the card and launches the kernels.
* **Through a ``TorchDispatchMode``**, with
  ``torch.utils.flop_counter.FlopCounterMode`` around the same run (its
  total is kept as ``raw_flops``: it counts only the registered products,
  and no in-place one).  The recorder keeps its state on its own instance:
  dispatch modes are thread-local, so threads record different workloads
  at once.
* **Eager runs unroll Python loops**, so there are no trip counts to
  read: every iteration is recorded.  A ``torch.ops.higher_order.
  while_loop`` node is recorded as one op and counts as one trip in
  ``unknown_trip_counts``, as the reference counts a loop whose count it
  cannot read.

The walk differs from XLA's in one way by nature: eager PyTorch does not
fuse, so ``flops`` (1 per output element of every op) and
``traffic_bytes`` (operands plus outputs of every op) count each
intermediate that XLA would keep in a fusion.  The products
(``mxu_flops``), ``gather_bytes`` and ``nonvec_flops`` are the
reference's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.core.counters import collective_of, tensor_bytes

#: Bumped when a rule changes what a recording costs: part of every
#: workload fingerprint (``analysis/store.py``), so stored events of an
#: older rule set are never read back as this one's.
COST_MODEL_VERSION = 1


# ---------------------------------------------------------------------------
# The recording
# ---------------------------------------------------------------------------


class TensorMeta(tuple):
    """What a recording keeps of a tensor: its shape (the tuple itself)
    and its dtype.  Being a shape, it is what ``flop_registry``'s formulas
    read, whether they take shapes or tensors (``.shape``)."""

    dtype: torch.dtype

    def __new__(cls, shape: Sequence[int], dtype: torch.dtype) -> "TensorMeta":
        meta = super().__new__(cls, (int(d) for d in shape))
        meta.dtype = dtype
        return meta

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self)

    def numel(self) -> int:
        n = 1
        for d in self:
            n *= d
        return n

    def __repr__(self) -> str:
        return f"TensorMeta({tuple(self)}, {self.dtype})"


_SCALARS = (int, float, bool, complex, str, type(None), torch.dtype,
            torch.device, torch.layout, torch.memory_format)


def _meta(x: Any) -> Any:
    """A recorded leaf: tensors become TensorMeta, plain values stay, any
    other object (a process group, a callable) becomes its type's name."""
    if isinstance(x, torch.Tensor):
        return TensorMeta(x.shape, x.dtype)
    if isinstance(x, _SCALARS):
        return x
    return type(x).__name__


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched operator: ``namespace::packet.overload``."""

    namespace: str
    packet: str
    overload: str = "default"
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    outputs: Any = ()

    @property
    def key(self) -> str:
        """The rule key: the bare packet for aten, ``ns.packet`` else."""
        if self.namespace == "aten":
            return self.packet
        return f"{self.namespace}.{self.packet}"

    @property
    def operands(self) -> List[TensorMeta]:
        return [x for x in tree_leaves((self.args, self.kwargs))
                if isinstance(x, TensorMeta)]

    @property
    def results(self) -> List[TensorMeta]:
        return [x for x in tree_leaves(self.outputs)
                if isinstance(x, TensorMeta)]


@dataclasses.dataclass(frozen=True)
class Recording:
    """The port's compiled artifact: the ops of one run, with the memory
    the run held (bytes, on the CPU) and ``FlopCounterMode``'s total."""

    ops: Tuple[Op, ...] = ()
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0  # peak of live storages the run allocated
    raw_flops: float = 0.0
    seconds: float = 0.0


def _names(func: Any) -> Tuple[str, str, str]:
    if isinstance(func, torch._ops.OpOverload):
        return func.namespace, func.overloadpacket.__name__, func._overloadname
    return getattr(func, "namespace", "higher_order"), func.__name__, ""


class _Recorder(TorchDispatchMode):
    """Appends one :class:`Op` per dispatched operator and tracks the
    bytes of live storages the run allocated (arguments excluded)."""

    supports_higher_order_operators = True

    def __init__(self, argument_storages: set) -> None:
        super().__init__()
        self.ops: List[Op] = []
        self.peak_bytes = 0
        self._lock = threading.Lock()
        self._arguments = argument_storages
        self._live: Dict[int, List[int]] = {}  # storage -> [bytes, tensors]
        self._live_bytes = 0
        self._tracked: Dict[int, int] = {}  # id(tensor) -> storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, packet, overload = _names(func)
        self.ops.append(Op(ns, packet, overload, tree_map(_meta, tuple(args)),
                           tree_map(_meta, dict(kwargs)), tree_map(_meta, out)))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key, nbytes = storage.data_ptr(), storage.nbytes()
        if nbytes == 0 or key in self._arguments or id(t) in self._tracked:
            return
        with self._lock:
            self._tracked[id(t)] = key
            entry = self._live.setdefault(key, [nbytes, 0])
            if entry[1] == 0:
                self._live_bytes += nbytes
                self.peak_bytes = max(self.peak_bytes, self._live_bytes)
            entry[1] += 1
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        with self._lock:
            self._tracked.pop(tid, None)
            entry = self._live.get(key)
            if entry is None:
                return
            entry[1] -= 1
            if entry[1] == 0:
                self._live_bytes -= entry[0]
                del self._live[key]


def _cpu_copy(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


def record(fn: Callable, args: Sequence[Any]) -> Recording:
    """Run ``fn`` once on CPU copies of ``args`` under ``torch.no_grad()``
    and record every aten operator it dispatches (see the module
    docstring).  What ``fn`` raises propagates."""
    with torch.no_grad():
        copies = tree_map(_cpu_copy, tuple(args))
        inputs = [a for a in tree_leaves(copies) if isinstance(a, torch.Tensor)]
        recorder = _Recorder({a.untyped_storage().data_ptr() for a in inputs})
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as counter, recorder:
            out = fn(*copies)
        seconds = time.perf_counter() - t0
    outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    return Recording(
        ops=tuple(recorder.ops),
        argument_bytes=float(sum(tensor_bytes(a) for a in inputs)),
        output_bytes=float(sum(tensor_bytes(t) for t in outputs)),
        temp_bytes=float(recorder.peak_bytes),
        raw_flops=float(counter.get_total_flops()),
        seconds=seconds,
    )


# ---------------------------------------------------------------------------
# The rules (hlo_cost.py:302-415, onto aten ops)
# ---------------------------------------------------------------------------

#: packet name -> flop formula, the in-place products under their own
#: names (``addmm_`` counts as ``addmm``: the plain GEMM accumulates in
#: place)
_PRODUCTS: Dict[str, Callable] = {
    getattr(packet, "__name__", str(packet)): formula
    for packet, formula in flop_registry.items()
}
_PRODUCTS.update({f"{name}_": f for name, f in list(_PRODUCTS.items())
                  if not name.endswith("_")})

#: the products the census counts as convolutions (the rest are dots)
CONVOLUTIONS = frozenset({
    "convolution", "_convolution", "convolution_backward",
    "convolution_overrideable", "cudnn_convolution", "_slow_conv2d_forward"})

_FREE = (
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand", "permute",
    "transpose", "transpose_", "t", "t_", "squeeze", "squeeze_", "unsqueeze",
    "unsqueeze_", "slice", "select", "alias", "detach", "detach_",
    "as_strided", "split", "split_with_sizes", "unbind", "diagonal",
    "unfold", "view_as_real", "view_as_complex", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "lift_fresh")
_NONVEC = (
    "_fft_r2c", "_fft_c2c", "_fft_c2r", "sort", "topk", "rand", "rand_like",
    "randn", "randn_like", "randint", "randint_like", "randperm", "normal",
    "normal_", "uniform_", "bernoulli", "bernoulli_", "exponential_",
    "random_", "multinomial")
_UPDATE = ("copy_", "slice_scatter", "select_scatter", "diagonal_scatter",
           "as_strided_scatter")
_SCATTER = (
    "index_put", "index_put_", "_index_put_impl_", "index_copy",
    "index_copy_", "index_add", "index_add_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_")
_GATHER = ("gather", "index", "_unsafe_index", "index_select", "take",
           "embedding")

#: The rule set, one rule per op key (``Op.key``); a key not listed is
#: ``elementwise``:
#:
#: ============  ================================================  ==========
#: rule          flops                                             traffic
#: ============  ================================================  ==========
#: free          none (HLO's tuple/gte/parameter/bitcast)          none
#: product       ``flop_registry``'s formula, as ``mxu_flops``     in + out
#: nonvec        5 per output element, all ``nonvec`` (fft/sort/rng) in + out
#: update        the update's elements (dynamic-update-slice)      2 x update
#: scatter       as update; the update's bytes are gather bytes     2 x update
#: gather        1 per output element; output bytes are gather      2 x out
#: while         one trip in ``unknown_trip_counts``                none
#: elementwise   1 per output element                              in + out
#: ============  ================================================  ==========
#:
#: Collectives (``counters.collective_of``) are elementwise ops whose
#: input bytes are also counted by kind.  The update of an update or
#: scatter is the operands less the largest (``hlo_cost.py:364-372``).
RULES: Dict[str, str] = {
    **dict.fromkeys(_FREE, "free"),
    **dict.fromkeys(_PRODUCTS, "product"),
    **dict.fromkeys(_NONVEC, "nonvec"),
    **dict.fromkeys(_UPDATE, "update"),
    **dict.fromkeys(_SCATTER, "scatter"),
    **dict.fromkeys(_GATHER, "gather"),
    "higher_order.while_loop": "while",
}


def rule_of(op: Op) -> str:
    return RULES.get(op.key, "elementwise")


def product_flops(op: Op) -> float:
    """``flop_registry``'s count for a product op, from its shapes."""
    formula = _PRODUCTS[op.packet]
    return float(formula(*op.args, **op.kwargs, out_val=op.outputs))


# ---------------------------------------------------------------------------
# The cost walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpCost:
    """Structural cost of one recording (PER DEVICE), ``HloCost``'s fields."""

    mxu_flops: float = 0.0
    vpu_flop_estimate: float = 0.0
    nonvec_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_count_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    gather_bytes: float = 0.0
    while_trip_counts: List[int] = dataclasses.field(default_factory=list)
    unknown_trip_counts: int = 0

    @property
    def flops(self) -> float:
        return self.mxu_flops + self.vpu_flop_estimate

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["flops"] = self.flops
        return d


def _elements(metas: Sequence[TensorMeta]) -> float:
    return float(sum(m.numel() for m in metas))


def _bytes(metas: Sequence[TensorMeta]) -> float:
    return float(sum(tensor_bytes(m) for m in metas))


def _update(sizes: Sequence[float]) -> float:
    return sum(sizes) - max(sizes) if sizes else 0.0


def cost_of_recording(rec: Recording) -> OpCost:
    cost = OpCost()
    for op in rec.ops:
        rule = rule_of(op)
        if rule == "free":
            continue
        if rule == "while":
            cost.unknown_trip_counts += 1
            continue
        operands, results = op.operands, op.results
        in_out = _bytes(operands) + _bytes(results)
        if rule == "product":
            cost.mxu_flops += product_flops(op)
            cost.traffic_bytes += in_out
        elif rule == "nonvec":
            est = 5.0 * _elements(results)
            cost.vpu_flop_estimate += est
            cost.nonvec_flops += est
            cost.traffic_bytes += in_out
        elif rule in ("update", "scatter"):
            update = _update([tensor_bytes(m) for m in operands])
            cost.vpu_flop_estimate += _update([m.numel() for m in operands])
            cost.traffic_bytes += 2.0 * update
            if rule == "scatter":
                cost.gather_bytes += update
        elif rule == "gather":
            out = _bytes(results)
            cost.vpu_flop_estimate += _elements(results)
            cost.traffic_bytes += 2.0 * out
            cost.gather_bytes += out
        else:
            cost.vpu_flop_estimate += _elements(results)
            cost.traffic_bytes += in_out
            collective = collective_of(op)
            if collective is not None:
                kind, nbytes = collective
                cost.collective_bytes += nbytes
                cost.collective_bytes_by_kind[kind] = (
                    cost.collective_bytes_by_kind.get(kind, 0.0) + nbytes)
                cost.collective_count_by_kind[kind] = (
                    cost.collective_count_by_kind.get(kind, 0) + 1)
    return cost
