"""The paper's Table-1 event set (the analytic half of
:mod:`repro.core.counters`).

The reference derives these events from XLA's compiled artifacts (HLO text,
``cost_analysis``) or from an application's analytic model.  The port
carries the :class:`Events` record and the analytic source; a source from
the port's own traced programs waits for ROADMAP item 1.17.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping


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
