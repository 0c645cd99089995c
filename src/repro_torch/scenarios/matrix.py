"""Declarative scenario matrices: axes -> cartesian, seeded `Scenario` cells.

Port of ``repro/scenarios/matrix.py``: the same axes, cell ids, traffic
keys and seeds.  The schedulers are the port engine's and mesh shapes
are parsed by the port's ``launch/mesh.py``.

A :class:`MatrixSpec` names one value-list per traffic axis — arrival
process x prompt-length distribution x EOS-probability x scheduler x
architecture x fault plan x device mesh — and :meth:`MatrixSpec.cells` expands the
cartesian product into :class:`Scenario` cells (skipping combinations a
fault plan declares invalid, e.g. slot preemption under the lockstep wave
scheduler, which has no slots to preempt).

Every cell carries a **derived seed**: SHA-256 over the spec seed and the
cell's *traffic* key.  Two properties follow by construction:

* same spec => same sampled traffic, process- and machine-independent
  (the acceptance bar: a scenario is a reproducible experiment, not a
  lucky workload);
* the traffic key excludes the scheduler and the fault axis, so a faulted
  cell, its fault-free golden twin, and the same traffic under the other
  scheduler all sample IDENTICAL requests — the paper's methodology of
  varying one axis while pinning the rest (Sec. 5's per-app sweeps).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.serve.engine import SCHEDULERS

#: The architectures the serve engine serves.
SERVE_ARCHS = (
    "gpt2-124m", "qwen3-1.7b", "mamba2-370m", "deepseek-v2-lite-16b",
    "deepseek-moe-16b", "jamba-1.5-large-398b",
)


# ---------------------------------------------------------------------------
# Axis value specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """When requests arrive, measured in fused decode steps (the engine's
    clock): ``poisson`` (exponential interarrivals at ``rate`` requests per
    step), ``bursty`` (``burst`` requests every ``gap`` steps), or
    ``replay`` (explicit step offsets, cycled over the request count)."""

    kind: str = "poisson"
    rate: float = 0.5
    burst: int = 4
    gap: int = 24
    steps: Sequence[int] = ()

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty", "replay"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.kind == "poisson" and self.rate <= 0:
            raise ValueError("poisson arrival needs rate > 0")
        if self.kind == "replay" and not self.steps:
            raise ValueError("replay arrival needs explicit steps")
        object.__setattr__(self, "steps", tuple(int(s) for s in self.steps))

    @property
    def slug(self) -> str:
        if self.kind == "poisson":
            return f"poisson{self.rate:g}"
        if self.kind == "bursty":
            return f"burst{self.burst}x{self.gap}"
        return f"replay{len(self.steps)}"


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    """Prompt-length distribution: ``uniform`` on [lo, hi], ``fixed`` at
    ``n``, or ``bimodal`` (``long`` tokens with probability ``p_long``,
    else ``short`` — the ragged mix lockstep scheduling pads worst)."""

    kind: str = "uniform"
    lo: int = 4
    hi: int = 16
    n: int = 8
    short: int = 4
    long: int = 24
    p_long: float = 0.25

    def __post_init__(self):
        if self.kind not in ("uniform", "fixed", "bimodal"):
            raise ValueError(f"unknown prompt kind {self.kind!r}")
        if self.kind == "uniform" and not 1 <= self.lo <= self.hi:
            raise ValueError(f"bad uniform bounds [{self.lo}, {self.hi}]")

    @property
    def slug(self) -> str:
        if self.kind == "uniform":
            return f"u{self.lo}-{self.hi}"
        if self.kind == "fixed":
            return f"fix{self.n}"
        return f"bi{self.short}-{self.long}p{self.p_long:g}"


@dataclasses.dataclass(frozen=True)
class EosSpec:
    """Per-token stop probability.  Real EOS is a model-emitted token; for
    a seeded traffic model we sample the *consequence* instead: each
    request's token budget is capped at Geometric(``p_early``) (so
    completions go ragged exactly as stochastic EOS makes them), which
    keeps the trace deterministic under any parameter init."""

    p_early: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.p_early < 1.0:
            raise ValueError(f"p_early must be in [0, 1), got {self.p_early}")

    @property
    def slug(self) -> str:
        return f"eos{self.p_early:g}"


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-cell service-level floors/ceilings checked by the runner.

    Defaults are deliberately loose enough for shared CI runners — the
    machinery (violation -> failed cell -> non-zero gate exit) is the
    contract; operators tighten the numbers per deployment."""

    min_tok_s: float = 0.05
    max_p95_latency_s: float = 120.0
    max_ttft_p95_s: float = 120.0
    min_slot_utilization: float = 0.05
    #: optional ceiling on the DETERMINISTIC step-clock TTFT (fused steps
    #: from submit to first token): same trace => same value on any
    #: machine, so it can be pinned tight where wall ceilings stay loose.
    #: None disables the check (the default: it is a per-matrix contract).
    max_ttft_p95_steps: Optional[float] = None

    def check(self, stats: Mapping[str, Any]) -> List[str]:
        """Violation strings (empty = SLOs met)."""
        out = []
        checks = (
            ("tok_s", self.min_tok_s, "floor", "tok/s"),
            ("p95_latency_s", self.max_p95_latency_s, "ceiling", "p95 latency"),
            ("ttft_p95_s", self.max_ttft_p95_s, "ceiling", "p95 TTFT"),
            ("slot_utilization", self.min_slot_utilization, "floor",
             "slot utilization"),
        )
        if self.max_ttft_p95_steps is not None:
            checks += (("ttft_p95_steps", self.max_ttft_p95_steps,
                        "ceiling", "p95 TTFT steps"),)
        for name, bound, kind, label in checks:
            val = stats.get(name)
            if val is None:
                out.append(f"{label}: metric {name!r} missing from stats")
            elif kind == "floor" and float(val) < bound:
                out.append(f"{label} {float(val):.4g} < floor {bound:g}")
            elif kind == "ceiling" and float(val) > bound:
                out.append(f"{label} {float(val):.4g} > ceiling {bound:g}")
        return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One fully-pinned cell of the matrix: every axis chosen, seed derived."""

    arrival: ArrivalSpec
    prompt: PromptSpec
    eos: EosSpec
    scheduler: str
    arch: str
    fault: str
    requests: int
    max_new: int
    max_batch: int
    max_len: int
    block_size: int
    seed: int  # derived: see cell_seed()
    slo: SLOSpec = SLOSpec()
    prefill_chunk: int = 1
    prefill_budget: Optional[int] = None
    #: prefix-sharing axis: "none" = plain traffic, engine sharing off;
    #: "shared" = shared-prefix traffic, COW engine sharing ON;
    #: "shared-off" = the SAME shared-prefix traffic, sharing disabled
    #: (the golden baseline a "shared" cell is diffed against)
    prompt_sharing: str = "none"
    #: speculative-decoding axis: 0 = off, k > 0 = the engine drafts and
    #: verifies k tokens per fused target step (continuous only).  The
    #: axis never changes the sampled traffic — a speculating cell's
    #: golden baseline is the SAME cell with speculation off
    #: (:meth:`spec_twin`), which must serve byte-identical streams.
    spec_k: int = 0
    #: device-mesh axis: None = single-device serving, "DxM" = the engine
    #: shards params and the paged KV pool over a data-x-model mesh of
    #: ranks (continuous only).  Sharding never changes the sampled traffic — a
    #: meshed cell's golden baseline is the SAME cell unsharded
    #: (:meth:`mesh_twin`), which must serve byte-identical streams.
    mesh: Optional[str] = None

    def __post_init__(self):
        if self.prompt_sharing not in ("none", "shared", "shared-off"):
            raise ValueError(
                f"unknown prompt_sharing {self.prompt_sharing!r}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.mesh is not None:
            from repro_torch.launch.mesh import parse_mesh

            parse_mesh(self.mesh)  # raises MeshShapeError on junk

    @property
    def share_prefixes(self) -> bool:
        """Whether the ENGINE deduplicates (the traffic *shape* is shared
        for both "shared" and "shared-off")."""
        return self.prompt_sharing == "shared"

    @property
    def traffic_key(self) -> str:
        """Axes the sampled traffic depends on.  Scheduler, fault, the
        prefill-chunking axis, the speculation axis, and the sharing MODE
        are EXCLUDED so twins, cross-scheduler cells, and
        chunked-vs-token-by-token cells all share a trace.  The traffic *shape* (shared prefixes vs plain) is
        included — it changes the sampled prompts — but "shared" and
        "shared-off" collapse onto the same key, so the COW engine and its
        sharing-disabled baseline serve byte-identical requests."""
        parts = [
            self.arrival.slug, self.prompt.slug, self.eos.slug, self.arch,
            f"n{self.requests}", f"new{self.max_new}",
        ]
        if self.prompt_sharing != "none":
            parts.append("sharedpfx")
        return "/".join(parts)

    @property
    def cell_id(self) -> str:
        parts = [
            self.arrival.slug, self.prompt.slug, self.eos.slug,
            self.scheduler, self.arch, self.fault,
        ]
        if self.prefill_chunk > 1:
            parts.append(f"pc{self.prefill_chunk}")
        if self.prompt_sharing != "none":
            parts.append(self.prompt_sharing)
        if self.spec_k > 0:
            parts.append(f"spec{self.spec_k}")
        if self.mesh is not None:
            parts.append(f"m{self.mesh}")
        return "/".join(parts)

    @property
    def ledger_key(self) -> str:
        """Workload key of this cell's BenchRun row in the perf ledger."""
        return f"scenario/{self.cell_id}"

    def twin(self) -> "Scenario":
        """The fault-free golden twin: same everything, fault='none'.
        Shares the seed (fault is outside the traffic key), so both cells
        sample byte-identical traffic."""
        return dataclasses.replace(self, fault="none")

    def chunk_twin(self) -> "Scenario":
        """The token-by-token golden twin of a chunked-prefill cell: same
        traffic (the chunk axis is outside the traffic key), fault-free,
        ``prefill_chunk=1``.  Chunked serving must match it uid-for-uid."""
        return dataclasses.replace(self, fault="none", prefill_chunk=1,
                                   prefill_budget=None)

    def sharing_twin(self) -> "Scenario":
        """The sharing-disabled golden twin of a COW-sharing cell: same
        shared-prefix traffic (the sharing mode is outside the traffic
        key), fault-free, ``prompt_sharing="shared-off"``.  The COW engine
        must serve byte-identical streams while storing strictly fewer
        physical blocks."""
        return dataclasses.replace(self, fault="none",
                                   prompt_sharing="shared-off")

    def spec_twin(self) -> "Scenario":
        """The speculation-off golden twin of a speculative cell: same
        traffic (the speculation axis is outside the traffic key),
        fault-free, ``spec_k=0``.  The speculative engine must serve
        byte-identical streams — speculation may only change how many
        fused target steps they cost."""
        return dataclasses.replace(self, fault="none", spec_k=0)

    def mesh_twin(self) -> "Scenario":
        """The unsharded golden twin of a meshed cell: same traffic (the
        mesh axis is outside the traffic key), fault-free, ``mesh=None``.
        The sharded engine must serve byte-identical streams — the mesh
        may only change where the math runs."""
        return dataclasses.replace(self, fault="none", mesh=None)


def cell_seed(spec_seed: int, traffic_key: str) -> int:
    """Deterministic 32-bit seed for one cell's traffic sampler."""
    digest = hashlib.sha256(f"{spec_seed}|{traffic_key}".encode()).digest()
    return int.from_bytes(digest[:4], "big")


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MatrixSpec:
    """The declarative matrix: one value-list per axis + shared sizing."""

    arrivals: List[ArrivalSpec] = dataclasses.field(
        default_factory=lambda: [ArrivalSpec()])
    prompts: List[PromptSpec] = dataclasses.field(
        default_factory=lambda: [PromptSpec()])
    eos: List[EosSpec] = dataclasses.field(
        default_factory=lambda: [EosSpec()])
    schedulers: List[str] = dataclasses.field(
        default_factory=lambda: list(SCHEDULERS))
    archs: List[str] = dataclasses.field(
        default_factory=lambda: ["gpt2-124m"])
    faults: List[str] = dataclasses.field(
        default_factory=lambda: ["none"])
    #: prefill-chunking axis: 1 = token-by-token, >1 = chunked prefill
    #: (continuous scheduler only; wave combos are skipped)
    prefill_chunks: List[int] = dataclasses.field(
        default_factory=lambda: [1])
    prefill_budget: Optional[int] = None
    #: prefix-sharing axis ("none" / "shared" / "shared-off"): sharing
    #: cells run continuous-only (the wave path has no block pool to
    #: deduplicate); "shared" cells are golden-diffed against their
    #: sharing-disabled twin by the runner
    prompt_sharing: List[str] = dataclasses.field(
        default_factory=lambda: ["none"])
    #: speculative-decoding axis (0 = off, k > 0 = draft/verify width):
    #: speculating cells run continuous-only and are golden-diffed
    #: against their speculation-off twin by the runner
    speculate: List[int] = dataclasses.field(
        default_factory=lambda: [0])
    #: device-mesh axis (None = single device, "DxM" = tensor-parallel
    #: serving over a data-x-model mesh of ranks): meshed cells run
    #: continuous-only and are golden-diffed against their unsharded
    #: twin by the runner, which spawns the mesh's ranks to serve them.
    meshes: List[Optional[str]] = dataclasses.field(
        default_factory=lambda: [None])
    requests: int = 6
    max_new: int = 8
    max_batch: int = 2
    max_len: int = 64
    block_size: int = 8
    seed: int = 0
    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)

    def cells(self) -> List[Scenario]:
        """Cartesian expansion, invalid (fault x scheduler) combos skipped."""
        import itertools

        from repro_torch.scenarios.faults import get_plan  # cycle-free at call time

        out: List[Scenario] = []
        for sched in self.schedulers:
            if sched not in SCHEDULERS:
                raise ValueError(f"unknown scheduler {sched!r}")
        combos = itertools.product(
            self.archs, self.schedulers, self.arrivals, self.prompts,
            self.eos, self.faults, self.prefill_chunks, self.prompt_sharing,
            self.speculate, self.meshes,
        )
        for arch, sched, arr, pr, eo, fault, pc, ps, sk, mesh in combos:
            if pc > 1 and sched != "continuous":
                continue  # wave has no chunked path
            if ps != "none" and sched != "continuous":
                continue  # wave has no block pool to deduplicate
            if sk > 0 and sched != "continuous":
                continue  # speculation verifies over the paged cache
            if sk > 0 and pc > 1:
                continue  # speculation owns the multi-token window
            if mesh is not None and sched != "continuous":
                continue  # only the paged continuous path is sharded
            cell = Scenario(
                arrival=arr, prompt=pr, eos=eo,
                scheduler=sched, arch=arch, fault=fault,
                requests=self.requests,
                max_new=self.max_new,
                max_batch=self.max_batch,
                max_len=self.max_len,
                block_size=self.block_size,
                seed=0, slo=self.slo,
                prefill_chunk=pc,
                prefill_budget=self.prefill_budget if pc > 1 else None,
                prompt_sharing=ps,
                spec_k=sk,
                mesh=mesh,
            )
            if not get_plan(fault).applies_to(cell):
                continue
            out.append(dataclasses.replace(
                cell, seed=cell_seed(self.seed, cell.traffic_key),
            ))
        return out

    # -- JSON round-trip (spec files for the CLI) ---------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for arr in d["arrivals"]:
            arr["steps"] = list(arr["steps"])
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MatrixSpec":
        kw: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name == "arrivals":
                v = [ArrivalSpec(**a) for a in v]
            elif f.name == "prompts":
                v = [PromptSpec(**a) for a in v]
            elif f.name == "eos":
                v = [EosSpec(**a) for a in v]
            elif f.name == "slo":
                v = SLOSpec(**v)
            kw[f.name] = v
        return cls(**kw)

    @classmethod
    def from_json(cls, path: str) -> "MatrixSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def smoke_matrix() -> MatrixSpec:
    """The CI matrix: 2 archs x both schedulers x every fault plan, over
    Poisson arrivals on ragged uniform prompts with stochastic early stop."""
    return MatrixSpec(
        arrivals=[ArrivalSpec(kind="poisson", rate=0.5)],
        prompts=[PromptSpec(kind="uniform", lo=4, hi=12)],
        eos=[EosSpec(p_early=0.1)],
        schedulers=list(SCHEDULERS),
        archs=["gpt2-124m", "qwen3-1.7b"],
        faults=["none", "preempt", "device-loss", "malformed"],
        requests=6,
        max_new=8,
        max_batch=2,
        max_len=64,
        block_size=8,
    )


def full_matrix() -> MatrixSpec:
    """The wide matrix: every arrival/length/EOS shape, all six serve
    architectures, every fault plan.  Expansion is cheap; running it is an
    operator decision (``--only`` filters, ``--jobs`` fans out)."""
    return MatrixSpec(
        arrivals=[
            ArrivalSpec(kind="poisson", rate=0.5),
            ArrivalSpec(kind="bursty", burst=4, gap=24),
            ArrivalSpec(kind="replay", steps=(0, 0, 1, 5, 9, 30)),
        ],
        prompts=[
            PromptSpec(kind="uniform", lo=4, hi=16),
            PromptSpec(kind="bimodal", short=4, long=24, p_long=0.25),
        ],
        eos=[EosSpec(p_early=0.0), EosSpec(p_early=0.15)],
        schedulers=list(SCHEDULERS),
        archs=list(SERVE_ARCHS),
        faults=["none", "preempt", "device-loss", "malformed"],
        prompt_sharing=["none", "shared"],
        speculate=[0, 4],
        meshes=[None, "1x1"],
        requests=8,
        max_new=8,
        max_batch=2,
        max_len=64,
        block_size=8,
    )


MATRICES = {"smoke": smoke_matrix, "full": full_matrix}


def load_matrix(name_or_path: Optional[str]) -> MatrixSpec:
    """Resolve a named matrix ('smoke', 'full') or a JSON spec file."""
    if not name_or_path:
        return smoke_matrix()
    if name_or_path in MATRICES:
        return MATRICES[name_or_path]()
    return MatrixSpec.from_json(name_or_path)
