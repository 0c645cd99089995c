"""PMU-analogue performance counters, across from
:mod:`repro.core.counters`.

The paper (Sec. 3.1, Table 1) profiles six validated ARM PMU events
through a perf wrapper.  The reference derives them from XLA's compiled
artifacts; the port derives them from its own compiled artifact, a
:class:`~repro_torch.core.op_cost.Recording` of the aten operators one run
of the workload dispatches (on the CPU, see :mod:`repro_torch.core.op_cost`),
or from an application's analytic model:

==================  ==========================================================
paper event          recording definition
==================  ==========================================================
INST_RETIRED         vector-issue count (elements / lanes, per op census)
LL_CACHE_MISS_RD     HBM read bytes (half the structural traffic)
MEM_ACCESS_RD        structural traffic: operand + output bytes of every op
STALL_BACKEND        max(0, mem_time - compute_time) in cycles-equivalent
CPU_CYCLES           max(compute, memory, collective) time x clock
VFP_SPEC             FLOPs: ``flop_registry`` products + 1 per output element
==================  ==========================================================

plus the structural counters the decision tree needs: collective bytes by
kind (the ``_c10d_functional`` and in-place ``c10d`` ops, under the
reference's kind names), gather/scatter bytes (pointer-chasing traffic),
and the product/elementwise FLOP share ("vectorizable fraction").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves

DTYPE_BYTES: Mapping[torch.dtype, int] = {
    dt: dt.itemsize for dt in (
        torch.bool, torch.uint8, torch.int8, torch.float8_e4m3fn,
        torch.float8_e5m2, torch.int16, torch.uint16, torch.float16,
        torch.bfloat16, torch.int32, torch.uint32, torch.float32,
        torch.complex32, torch.int64, torch.uint64, torch.float64,
        torch.complex64, torch.complex128)
}


def tensor_bytes(t: Any) -> float:
    """Bytes of a tensor, or of a recorded ``TensorMeta``."""
    n = t.numel()
    return float(n * DTYPE_BYTES.get(t.dtype, t.dtype.itemsize))


#: the reference's collective kinds, in its order
_COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
)

#: op key -> (kind, index of the argument holding the inputs)
COLLECTIVE_OPS: Mapping[str, Tuple[str, int]] = {
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional.broadcast": ("collective-broadcast", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.broadcast_": ("collective-broadcast", 0),
}


def collective_of(op: Any) -> Optional[Tuple[str, float]]:
    """(kind, bytes) of a recorded collective op, else None: the bytes of
    its input tensors, or of its outputs when it has none (as
    ``repro.core.counters.parse_collectives`` falls back to the output
    shape)."""
    entry = COLLECTIVE_OPS.get(op.key)
    if entry is None:
        return None
    kind, index = entry
    inputs = op.args[index] if index < len(op.args) else ()
    nbytes = sum(tensor_bytes(m) for m in tree_leaves(inputs)
                 if hasattr(m, "dtype"))
    if nbytes == 0.0:
        nbytes = sum(tensor_bytes(m) for m in op.results)
    return kind, float(nbytes)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    count_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CollectiveStats":
        return cls(
            bytes_by_kind={k: float(v) for k, v in (d.get("bytes_by_kind") or {}).items()},
            count_by_kind={k: int(v) for k, v in (d.get("count_by_kind") or {}).items()},
        )


def parse_collectives(recording: Any) -> CollectiveStats:
    """Input bytes and count of every collective op of a recording."""
    stats = CollectiveStats()
    for op in recording.ops:
        found = collective_of(op)
        if found is None:
            continue
        kind, nbytes = found
        stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0.0) + nbytes
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + 1
    return stats


def op_census(recording: Any) -> Dict[str, int]:
    """Op counts under the reference's census keys; ``fusion`` is 0 in
    eager PyTorch, and ``while`` counts ``while_loop`` nodes."""
    from repro_torch.core.op_cost import CONVOLUTIONS, rule_of

    census = dict.fromkeys(("dot", "convolution", "fusion", "gather",
                            "scatter", "fft", "sort", "while"), 0)
    for op in recording.ops:
        rule = rule_of(op)
        if rule == "product":
            census["convolution" if op.packet in CONVOLUTIONS else "dot"] += 1
        elif rule in ("gather", "scatter", "while"):
            census[rule] += 1
        elif op.packet.startswith("_fft_"):
            census["fft"] += 1
        elif op.packet in ("sort", "topk"):
            census["sort"] += 1
    stats = parse_collectives(recording)
    for kind in _COLLECTIVE_KINDS:
        census[kind] = stats.count_by_kind.get(kind, 0)
    return census



@dataclasses.dataclass
class Events:
    """The paper's Table-1 event set, artifact-derived, GLOBAL across chips."""

    flops: float = 0.0  # VFP_SPEC analogue
    bytes_accessed: float = 0.0  # MEM_ACCESS_* analogue (bytes)
    hbm_read_bytes: float = 0.0  # LL_CACHE_MISS_RD analogue (bytes)
    gather_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)
    mxu_flops: float = 0.0
    census: Dict[str, int] = dataclasses.field(default_factory=dict)
    n_devices: int = 1
    # raw per-device cost_analysis numbers (NOT loop-scaled; see
    # events_from_compiled docstring) — kept for counter validation
    xla_raw_flops: float = 0.0
    xla_raw_bytes: float = 0.0
    hlo_traffic_bytes: float = 0.0  # structural HLO traffic (diagnostic)
    nonvec_flops: float = 0.0  # fft/sort/serial flops (not lane-parallel)
    while_trip_counts: list = dataclasses.field(default_factory=list)
    unknown_trip_counts: int = 0
    # memory_analysis (per device, bytes)
    argument_bytes_per_device: float = 0.0
    output_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0
    code_bytes_per_device: float = 0.0

    @property
    def vectorizable_fraction(self) -> float:
        """Share of FLOPs that can use a data-parallel engine (MXU matmuls
        or VPU lanes); fft/sort/serial library structure is the exception —
        the paper's 'can it vectorize' filter."""
        if self.flops <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.nonvec_flops / self.flops))

    @property
    def mxu_fraction(self) -> float:
        if self.flops <= 0:
            return 0.0
        return min(1.0, self.mxu_flops / self.flops)

    @property
    def peak_bytes_per_device(self) -> float:
        return (
            self.argument_bytes_per_device
            + self.output_bytes_per_device
            + self.temp_bytes_per_device
        )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["collectives"] = {
            "bytes_by_kind": dict(self.collectives.bytes_by_kind),
            "count_by_kind": dict(self.collectives.count_by_kind),
        }
        d["vectorizable_fraction"] = self.vectorizable_fraction
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Events":
        """Inverse of :meth:`to_dict` (the artifact store's JSON round-trip).

        Derived keys (``vectorizable_fraction``) and unknown keys from newer
        writers are ignored; missing fields keep their defaults, so stored
        events written by older code still load.
        """
        ev = cls()
        valid = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k == "collectives":
                ev.collectives = CollectiveStats.from_dict(v or {})
            elif k == "census":
                ev.census = {str(n): int(c) for n, c in (v or {}).items()}
            elif k == "while_trip_counts":
                ev.while_trip_counts = list(v or [])
            elif k in valid:
                setattr(ev, k, type(getattr(ev, k))(v))
        return ev



def events_from_compiled(recording: Any, *, n_devices: int = 1) -> Events:
    """Events from a :class:`~repro_torch.core.op_cost.Recording`, as the
    reference's ``events_from_compiled`` derives them from an XLA artifact.

    The primary quantities come from the structural walk
    (``op_cost.cost_of_recording``) and are GLOBAL across chips
    (x ``n_devices``), so roofline terms follow
    term = global / (chips * per_chip_rate); so is the census.  The raw
    counter kept for validation is ``FlopCounterMode``'s total
    (``xla_raw_flops``, per device; it counts only registered products).
    PyTorch has no byte counter, so ``xla_raw_bytes`` is 0.  Eager loops
    are unrolled in the recording: ``while_trip_counts`` is ``[]``.  The
    memory fields are the run's on the CPU: the example arguments, the
    result and the peak of live intermediates.
    """
    from repro_torch.core.op_cost import cost_of_recording

    n = max(int(n_devices), 1)
    hc = cost_of_recording(recording)
    ev = Events()
    ev.n_devices = n
    ev.xla_raw_flops = float(recording.raw_flops)
    ev.flops = hc.flops * n
    ev.mxu_flops = hc.mxu_flops * n
    ev.bytes_accessed = hc.traffic_bytes * n
    ev.hbm_read_bytes = hc.traffic_bytes * 0.5 * n
    ev.gather_bytes = hc.gather_bytes * n
    ev.nonvec_flops = hc.nonvec_flops * n
    ev.collective_bytes = hc.collective_bytes * n
    ev.collectives = CollectiveStats(
        bytes_by_kind={k: v * n for k, v in hc.collective_bytes_by_kind.items()},
        count_by_kind=dict(hc.collective_count_by_kind),
    )
    ev.census = {k: v * n for k, v in op_census(recording).items()}
    ev.while_trip_counts = list(hc.while_trip_counts)
    ev.unknown_trip_counts = hc.unknown_trip_counts
    ev.argument_bytes_per_device = float(recording.argument_bytes)
    ev.output_bytes_per_device = float(recording.output_bytes)
    ev.temp_bytes_per_device = float(recording.temp_bytes)
    return ev


def events_from_analytic(
    *,
    flops: float,
    hbm_bytes: float,
    gather_bytes: float = 0.0,
    mxu_flops: float | None = None,
    collective_bytes: float = 0.0,
    n_devices: int = 1,
) -> Events:
    """Build Events from an analytic app model (paper Sec. 3.3 style)."""
    ev = Events()
    ev.flops = flops
    ev.bytes_accessed = hbm_bytes
    ev.hbm_read_bytes = hbm_bytes
    ev.gather_bytes = gather_bytes
    ev.mxu_flops = flops if mxu_flops is None else mxu_flops
    ev.collective_bytes = collective_bytes
    ev.n_devices = n_devices
    return ev
