"""Persisted tuning records: the content-addressed best-known configs (a
port of :mod:`repro.tuning.records`).

A :class:`TuningRecord` captures the outcome of one :func:`~repro_torch.tuning.
tune.tune` run — the winning config, the measured best/default times, the
roofline-predicted times, and how much of the space was pruned analytically
versus timed.  Records persist through the same content-addressed
:class:`~repro_torch.analysis.store.ArtifactStore` machinery the analysis
pipeline uses for recorded events (atomic writes, corrupt-entry
recovery), in a ``tuning/`` subdirectory of the port's artifact directory
(``$REPRO_ARTIFACT_DIR/torch/tuning``) — so the
zero-recompile story of the event store extends to a zero-re-tune story: a
second process asking to tune an already-tuned (kernel, chip, dtype) gets a
store hit and performs **zero timing runs**.

The payload layout (``workload``, ``kind: "tuning"``, ``tuning_version``,
``record``) is the reference's, so either package reads a record the other
wrote, and :mod:`repro_torch.perf.triage` scans the store unchanged.  The
fingerprint is the tuning analogue of
:func:`~repro_torch.analysis.store.workload_fingerprint`:

    kernel fn bytecode hash + example-arg shapes/dtypes + chip + dtype +
    the declarative space content + versions

so changing the kernel body, the problem shape, the chip model, the ELEN,
or the search space re-tunes; nothing else does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional, Tuple

from repro_torch.analysis.store import (
    ArtifactStore,
    _default_dir,
    _store_for,
    arg_signature,
    fn_token,
)
from repro_torch.tuning.space import TuningSpace

TUNING_VERSION = 1


@dataclasses.dataclass
class TuningRecord:
    """Best-known config for one (kernel, chip, dtype) on one problem."""

    kernel: str
    chip: str
    dtype: str
    fingerprint: str
    config: Dict[str, Any]
    default_config: Dict[str, Any]
    best_time_s: float
    default_time_s: float
    predicted_best_s: float = 0.0
    predicted_default_s: float = 0.0
    space_size: int = 0  # raw cartesian size of the searched space
    candidates: int = 0  # valid configs after clamp/dedup/VMEM
    pruned: int = 0  # dropped by the roofline score before timing
    timed: int = 0  # configs actually timed by the original run
    mode: str = "interpret"
    problem: str = ""
    # runtime-only: True when this record came from the store (not persisted)
    cached: bool = dataclasses.field(default=False, compare=False)

    @property
    def speedup_vs_default(self) -> float:
        """Measured best-vs-default speedup (1.0 when default won)."""
        if self.best_time_s <= 0:
            return 1.0
        return max(self.default_time_s / self.best_time_s, 1.0)

    @property
    def predicted_speedup(self) -> float:
        """Roofline-predicted tuned-vs-default speedup."""
        if self.predicted_best_s <= 0:
            return 1.0
        return max(self.predicted_default_s / self.predicted_best_s, 1.0)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("cached")
        d["speedup_vs_default"] = self.speedup_vs_default
        d["predicted_speedup"] = self.predicted_speedup
        d["cached"] = self.cached  # reported, but not trusted on load
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TuningRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields and k != "cached"})

    def row(self) -> Dict[str, Any]:
        """Flat projection for tables / tuning.json summaries."""
        return {
            "kernel": self.kernel,
            "chip": self.chip,
            "dtype": self.dtype,
            "config": " ".join(f"{k}={v}" for k, v in sorted(self.config.items())),
            "best_ms": f"{self.best_time_s * 1e3:.3f}",
            "default_ms": f"{self.default_time_s * 1e3:.3f}",
            "speedup": f"{self.speedup_vs_default:.3g}x",
            "pred": f"{self.predicted_speedup:.3g}x",
            "timed": self.timed,
            "pruned": self.pruned,
            "cached": self.cached,
        }


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def tuning_fingerprint(
    kernel: str,
    fn: Any,
    args: Tuple,
    chip: str,
    dtype: str,
    space: TuningSpace,
) -> str:
    """Content address of one tuning decision (see module docstring)."""
    h = hashlib.sha256()
    h.update(f"tuning-v{TUNING_VERSION}|{kernel}|{chip}|{dtype}|".encode())
    h.update(space.token().encode())
    h.update(b"|")
    for a in args:
        h.update(arg_signature(a).encode())
        h.update(b";")
    h.update(fn_token(fn).encode())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# The store (an ArtifactStore over the tuning/ subdirectory)
# ---------------------------------------------------------------------------


def default_tuning_dir() -> str:
    """``<the port's artifact dir>/tuning`` — rides ``$REPRO_ARTIFACT_DIR``
    so test isolation and operator overrides cover tuning records for
    free."""
    return os.path.join(_default_dir(), "tuning")


def default_tuning_store() -> ArtifactStore:
    return _store_for(default_tuning_dir())


def resolve_store(store: Any) -> Optional[ArtifactStore]:
    """None -> no persistence; "default" -> the shared tuning store; any
    other string -> a store rooted at that directory; pass-through else."""
    if store is None or isinstance(store, ArtifactStore):
        return store
    if store == "default":
        return default_tuning_store()
    return _store_for(str(store))


def load_record(store: ArtifactStore, fingerprint: str) -> Optional[TuningRecord]:
    """Record for ``fingerprint``, or None; corrupt payloads are dropped."""
    payload = store.get_json(fingerprint)
    if payload is None:
        return None
    try:
        if payload.get("tuning_version") != TUNING_VERSION:
            raise ValueError(f"tuning version {payload.get('tuning_version')}")
        rec = TuningRecord.from_dict(payload["record"])
    except (ValueError, KeyError, TypeError):
        store.discard(fingerprint)  # reverses the get_json hit
        return None
    rec.cached = True
    return rec


def save_record(store: ArtifactStore, record: TuningRecord) -> str:
    return store.put_json(
        record.fingerprint,
        {
            "workload": record.kernel,
            "kind": "tuning",
            "tuning_version": TUNING_VERSION,
            "record": record.to_dict(),
        },
    )
