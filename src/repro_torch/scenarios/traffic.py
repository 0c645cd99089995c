"""Seeded traffic sampling: one cell -> one reproducible request trace.

Port of ``repro/scenarios/traffic.py``: the same generator and draw
order, so every cell gives the reference's trace byte for byte.

All randomness flows from the cell's derived seed through a single
``numpy`` generator with a FIXED draw order (arrivals first, then per-uid
length -> tokens -> stop cap), so the trace is a pure function of the
spec — rerunning a matrix anywhere regenerates byte-identical traffic,
and a faulted cell's golden twin (same seed, fault excluded from the
seed derivation) serves exactly the same requests.

Arrival times are measured in **fused decode steps** — the engine's own
clock — not wall seconds: step-time varies by machine, and a
wall-clock arrival process would make the admission pattern (hence slot
scheduling, hence utilization) machine-dependent.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.scenarios.matrix import (ArrivalSpec, EosSpec, PromptSpec,
                                         Scenario)


@dataclasses.dataclass
class RequestSpec:
    """One sampled request: everything the engine's submit() needs, plus
    the arrival step the feeder honors.  ``malformed`` marks requests a
    fault plan injected expressly to be rejected ('' = well-formed)."""

    uid: int
    arrive_step: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int = -1
    malformed: str = ""


def _arrival_steps(spec: ArrivalSpec, n: int, rng: np.random.Generator) -> List[int]:
    if spec.kind == "poisson":
        gaps = rng.exponential(scale=1.0 / spec.rate, size=n)
        return [int(t) for t in np.floor(np.cumsum(gaps) - gaps[0])]
    if spec.kind == "bursty":
        return [(i // spec.burst) * spec.gap for i in range(n)]
    # replay: cycle the explicit offsets over the request count
    steps = sorted(spec.steps[i % len(spec.steps)] for i in range(n))
    return [int(s) for s in steps]


def _prompt_len(spec: PromptSpec, rng: np.random.Generator) -> int:
    if spec.kind == "uniform":
        return int(rng.integers(spec.lo, spec.hi + 1))
    if spec.kind == "fixed":
        return spec.n
    return spec.long if rng.random() < spec.p_long else spec.short


def _stop_cap(spec: EosSpec, max_new: int, rng: np.random.Generator) -> int:
    """Token budget under stochastic early stop: Geometric(p) capped at
    the cell budget.  p_early == 0 -> always the full budget.  The draw
    happens even at p == 0?  No — skipping it would shift later draws
    between eos=0 and eos>0 cells, but eos is part of the traffic key, so
    each eos choice is its own seeded stream and the order stays fixed
    *within* a cell."""
    if spec.p_early <= 0.0:
        return max_new
    return min(max_new, int(rng.geometric(spec.p_early)))


#: Prefix pools per shared-prefix cell and the unique-tail length bounds:
#: bimodal traffic — every request takes one of two long shared prefixes
#: and appends a short unique tail, the shape prefix caching feeds on.
_SHARED_GROUPS = 2
_TAIL_LO, _TAIL_HI = 1, 2


def _shared_prompts(cell: Scenario, vocab: int,
                    rng: np.random.Generator) -> List[np.ndarray]:
    """Per-uid prompts for a shared-prefix cell, FIXED draw order: group
    prefixes first (one per pool), then per-uid (group, tail length, tail
    tokens).  Prefix lengths come from the cell's prompt distribution,
    clamped so prefix + longest tail + budget always fits the slot cache;
    tails are unique per uid, so streams diverge right where copy-on-write
    must fork the last shared block."""
    room = cell.max_len - cell.max_new - _TAIL_HI
    groups = []
    for _ in range(_SHARED_GROUPS):
        plen = max(1, min(_prompt_len(cell.prompt, rng), room))
        groups.append(rng.integers(0, vocab, size=plen).astype(np.int32))
    prompts = []
    for _ in range(cell.requests):
        g = int(rng.integers(0, len(groups)))
        tail_len = int(rng.integers(_TAIL_LO, _TAIL_HI + 1))
        tail = rng.integers(0, vocab, size=tail_len).astype(np.int32)
        prompts.append(np.concatenate([groups[g], tail]))
    return prompts


def sample_trace(cell: Scenario, vocab: int) -> List[RequestSpec]:
    """The cell's reproducible request trace, sorted by arrival step.

    Prompt lengths are clamped so prompt + budget always fits the
    per-slot cache — well-formed by construction; the *malformed* fault
    plan injects its violations explicitly on top.  Shared-prefix cells
    (``prompt_sharing != "none"``) draw bimodal shared-prefix prompts —
    identical between "shared" and "shared-off" (the sharing MODE is
    outside the traffic key), so the COW engine and its baseline twin
    serve the same bytes.
    """
    rng = np.random.default_rng(cell.seed)
    arrivals = _arrival_steps(cell.arrival, cell.requests, rng)
    shared = (getattr(cell, "prompt_sharing", "none") != "none")
    prompts = _shared_prompts(cell, vocab, rng) if shared else None
    out: List[RequestSpec] = []
    for uid in range(cell.requests):
        if shared:
            prompt = prompts[uid]
        else:
            plen = _prompt_len(cell.prompt, rng)
            plen = max(1, min(plen, cell.max_len - cell.max_new))
            prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        out.append(RequestSpec(
            uid=uid,
            arrive_step=int(arrivals[uid]),
            prompt=prompt,
            max_new_tokens=_stop_cap(cell.eos, cell.max_new, rng),
        ))
    out.sort(key=lambda r: (r.arrive_step, r.uid))
    return out
