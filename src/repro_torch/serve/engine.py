"""Slot-level continuously batched serving engine over a paged KV cache,
and the lockstep wave scheduler over a dense cache.

Port of ``repro/serve/engine.py``, both of its schedulers.  A fixed
set of ``max_batch`` slots advances through fused steps, every slot at its
own cache position.  With ``prefill_chunk == 1`` every step is one
:func:`~repro_torch.models.transformer.decode_step_paged`, one token per
slot.  With ``prefill_chunk > 1`` (chunked prefill) a slot with known
tokens left (prompt, or a replay after preemption) feeds up to
``prefill_chunk`` of them per step, under a per-step ``prefill_budget`` of
prompt tokens that decode slots never count against; steps that carry a
chunk run :func:`~repro_torch.models.transformer.prefill_step_paged` at the
smallest power-of-two width that holds the widest chunk, and steps where
every busy slot decodes run ``decode_step_paged``.  When a request
finishes (EOS or token budget) its slot takes the next queued request on
the very next step and its blocks go back to the
:class:`~repro_torch.serve.block_pool.BlockPool` (LIFO, so the next
admission reuses them first).

``kv_dtype`` stores the K/V pools in the compute dtype ("f32"), bf16, or
int8 with one fp32 scale a pool row (quantized paging).  With
``share_prefixes`` the pool maps a prompt span that another slot already
holds to the same physical block (prefix sharing); a block that is about
to receive a generated-token row while other slots still reference it is
first copied to a private block (copy-on-write), so sharing changes where
rows are stored and never what a slot reads.

A model with mamba layers keeps per-slot recurrent state beside its
pools: the drain zeroes the state of every slot it admits a request to
(re-admission after a preemption included) before the first step that
feeds it.  Prefix sharing maps K/V blocks only: every prompt token still
runs through the mamba layers.

Scheduling state (positions, block tables, the pool's free list) is
host-side numpy; only the parameters, the K/V pools and the recurrent
states live on the device.
Each step hands the scheduler arrays to the device as private copies: the
drain mutates them in place right after the call.

Tensor-parallel serving: with ``mesh`` (a rank's
:class:`~repro_torch.launch.mesh.ServeMesh`), every rank of the mesh runs
its own engine over its shards of the parameters (``init_lm`` or
``params_from_numpy`` with ``mesh=``) and of the pools.  The host state
(scheduler, block pool, free list, tables) is the same on every rank:
each runs the same deterministic loop, computes and samples its own slots
(``local_slots``), and gathers the chosen tokens over ``data``, so every
rank appends the same tokens.  Rank 0 reports.

Sampling with ``temperature > 0`` (and ``top_k``) draws each token from
the reference's threefry key of ``(sample_seed, uid, index)``
(:mod:`repro_torch.serve.sampling`).  With ``spec_k > 0`` and a draft
model, :class:`~repro_torch.serve.speculative.SpeculativeDecoder` drains
the queue: the draft proposes up to ``spec_k`` tokens a slot and one chunk
step of the target verifies them.

``scheduler="wave"`` is the reference's lockstep golden baseline: up to
``max_batch`` queued requests are admitted as one wave into a fresh dense
cache (:func:`~repro_torch.models.transformer.init_cache`), and every slot
advances one token a fused step
(:func:`~repro_torch.models.transformer.decode_step`, every slot at one
position) until the wave's longest request is done; the next wave starts
only then.  Prompts are fed one token a step, idle slots feed token 0 and
finished ones their last token.  Both schedulers feed every request the
same tokens, so their greedy streams are equal, and the continuous one
takes no more fused steps.  The wave scheduler serves from the dense
cache in the compute dtype on one device: chunked prefill, quantized or
bf16 pools, prefix sharing, speculation and a mesh are refused with the
reference's messages.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import metrics as core_metrics
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.serve.block_pool import BlockPool
from repro_torch.serve.sampling import SlotSampler
from repro_torch.serve.speculative import SpeculativeDecoder

SCHEDULERS = ("continuous", "wave")

#: A step hook: called once per scheduling iteration with (engine, busy);
#: returns True while it may still deliver work (keeps the drain alive).
StepHook = Callable[["ServeEngine", bool], bool]

#: Spin cap for a fully idle engine whose hooks keep claiming pending
#: work without ever submitting any — a misbehaving hook, not traffic.
_MAX_IDLE_SPINS = 100_000


def _bucket_width(m: int, cap: int) -> int:
    """Smallest power of two >= m, clamped to cap: a prefill step's width,
    so partial chunks do not pay for the full chunk's padded rows."""
    w = 1
    while w < m:
        w *= 2
    return min(w, cap)


class RequestTooLong(ValueError):
    """Raised at submit() time when prompt + budget exceed one slot's
    cache."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never stops early

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        self.generated: List[int] = []
        self.done = False
        self.submitted_s: Optional[float] = None
        self.started_s: Optional[float] = None
        self.first_token_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        # step-clock twins of the wall-clock stamps: fused-step counter at
        # submit and at first token, deterministic given the trace
        self.submitted_step: Optional[int] = None
        self.first_token_step: Optional[int] = None

    @property
    def latency_s(self) -> Optional[float]:
        """Submit -> finish wall time (queue wait included)."""
        if self.submitted_s is None or self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit -> first generated token; replayed tokens never restamp
        it."""
        if self.submitted_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.submitted_s

    @property
    def ttft_steps(self) -> Optional[int]:
        """Fused steps between submit and first generated token."""
        if self.submitted_step is None or self.first_token_step is None:
            return None
        return self.first_token_step - self.submitted_step


def _validate(cfg, scheduler, max_len, block_size, prefill_chunk,
              prefill_budget, kv_dtype, share_prefixes, spec_k, draft_cfg,
              draft_params, spec_adaptive, mesh) -> None:
    """Raise ValueError for a bad option, with the reference's messages,
    in the reference's order."""
    transformer.check_served(cfg)
    if scheduler not in SCHEDULERS:
        raise ValueError(f"scheduler must be one of {SCHEDULERS}, "
                         f"got {scheduler!r}")
    if scheduler == "continuous" and max_len % block_size:
        # the wave scheduler's dense cache never touches the pool
        raise ValueError(f"max_len {max_len} must be a multiple of "
                         f"block_size {block_size}")
    if prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    if prefill_chunk > 1 and scheduler != "continuous":
        raise ValueError(
            "chunked prefill (prefill_chunk > 1) requires the "
            "continuous scheduler; wave mode replays prompts densely"
        )
    if prefill_budget is not None and prefill_budget < 1:
        raise ValueError(
            f"prefill_budget must be >= 1 (or None), got {prefill_budget}"
        )
    if kv_dtype not in transformer.KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {transformer.KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    if kv_dtype != "f32" and scheduler != "continuous":
        raise ValueError(
            "quantized KV blocks require the continuous scheduler; "
            "wave mode serves from the dense unquantized cache"
        )
    if share_prefixes and scheduler != "continuous":
        raise ValueError(
            "prefix sharing requires the continuous scheduler's "
            "paged block pool"
        )
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0 (0 = off), got {spec_k}")
    if spec_k > 0:
        if draft_cfg is None or draft_params is None:
            raise ValueError(
                "speculative decoding (spec_k > 0) requires a draft "
                "model: pass draft_cfg and draft_params"
            )
        if scheduler != "continuous":
            raise ValueError(
                "speculative decoding requires the continuous "
                "scheduler's paged cache"
            )
        if prefill_chunk > 1:
            raise ValueError(
                "speculative decoding runs its own multi-token "
                "verification window; combine it with prefill_chunk=1"
            )
    elif draft_cfg is not None or draft_params is not None:
        raise ValueError(
            "a draft model was provided but spec_k is 0; pass "
            "spec_k >= 1 to enable speculative decoding"
        )
    if spec_adaptive and spec_k == 0:
        raise ValueError(
            "spec_adaptive requires speculative decoding (spec_k >= 1)"
        )
    if mesh is not None:
        if scheduler != "continuous":
            raise ValueError(
                "mesh serving requires the continuous scheduler; wave "
                "mode is the single-device golden baseline"
            )
        for ax in ("data", "model"):
            if ax not in mesh.axis_names:
                raise ValueError(
                    f"serve mesh must carry ('data', 'model') axes, "
                    f"got {mesh.axis_names}"
                )


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 256, scheduler: str = "continuous",
                 block_size: int = 16, prefill_chunk: int = 1,
                 prefill_budget: Optional[int] = None,
                 kv_dtype: str = "f32", share_prefixes: bool = False,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, spec_k: int = 0,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None, spec_adaptive: bool = False,
                 mesh=None, device="cuda"):
        _validate(cfg, scheduler, max_len, block_size, prefill_chunk,
                  prefill_budget, kv_dtype, share_prefixes, spec_k,
                  draft_cfg, draft_params, spec_adaptive, mesh)
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the "
                             f"engine was asked for {self.device}")
        misplaced = [t.device for t in _leaves([params, draft_params])
                     if t is not None and t.device != self.device]
        if misplaced:
            raise ValueError(f"params lie on {misplaced[0]}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.scheduler = scheduler
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget
        self.kv_dtype = kv_dtype
        self.share_prefixes = share_prefixes
        self._sampler = SlotSampler(cfg.vocab, temperature=temperature,
                                    top_k=top_k, seed=sample_seed)
        self.temperature = self._sampler.temperature
        self.top_k = self._sampler.top_k
        self.sample_seed = self._sampler.seed
        self.spec_k = int(spec_k)
        self.spec_adaptive = bool(spec_adaptive)
        self.mesh = mesh
        # speculative decoding's counters (all zero when spec_k == 0): the
        # draft's proposals, and the draft's steps beside the target's
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rejected_tokens = 0
        self.draft_steps = 0
        self._spec: Optional[SpeculativeDecoder] = (
            SpeculativeDecoder(
                draft_cfg, draft_params, self.spec_k, target_cfg=cfg,
                block_size=block_size, temperature=self.temperature,
                top_k=self.top_k, seed=self.sample_seed,
                adaptive=self.spec_adaptive)
            if self.spec_k > 0 else None)
        self._has_state = transformer.has_state(cfg)
        self.queue: Deque[Request] = deque()
        self.completed: Dict[int, Request] = {}
        # slot accounting: fused steps are vector issues, slots are lanes,
        # busy_slot_steps counts the useful lane-steps
        self.steps = 0
        self.busy_slot_steps = 0
        self.wall_s = 0.0
        self.preemptions = 0
        # block-pool accounting, accumulated across drains
        self.logical_blocks = 0
        self.physical_blocks = 0
        self.shared_block_hits = 0
        self.cow_copies = 0
        #: step hooks (see the reference module): traffic feeders, faults
        self.step_hooks: List[StepHook] = []
        #: uid -> physical block ids the request occupied, in allocation
        #: order (pool-reuse introspection)
        self.block_history: Dict[int, List[int]] = {}
        # token-work budget for the drain-loop runaway guard: grows with
        # every submit (and preemption replay)
        self._submitted_work = 0
        # live drain state; only non-None while a continuous drain runs —
        # preempt() needs it
        self._live: Optional[Dict[str, Any]] = None
        # per-device busy-lane accounting: the data axis splits the slot
        # lanes over its ranks where it divides them; otherwise (and with
        # no mesh) there is one shard, and device_lane_utilization is
        # slot_utilization
        n_data = 1 if mesh is None else mesh.axis_size("data")
        self._lane_shards = n_data if max_batch % n_data == 0 else 1
        self._lanes_per_shard = max_batch // self._lane_shards
        self.device_busy_lane_steps = np.zeros(self._lane_shards, np.int64)

    # -- bookkeeping -----------------------------------------------------------

    @property
    def total_slot_steps(self) -> int:
        return self.steps * self.max_batch

    @property
    def slot_utilization(self) -> float:
        return core_metrics.slot_utilization(
            self.busy_slot_steps, self.steps, self.max_batch
        )

    @property
    def mesh_shape(self) -> Optional[str]:
        """The mesh as a ``DxM`` string, or None when serving unsharded."""
        return None if self.mesh is None else str(self.mesh)

    @property
    def device_lane_utilization(self) -> float:
        return core_metrics.device_lane_utilization(
            self.device_busy_lane_steps.tolist(), self.steps,
            self._lanes_per_shard,
        )

    def _note_busy(self, busy_flags) -> None:
        """Fold one fused step's per-slot busy flags into the busy-lane
        counter and the per-shard counters (slot ``b`` belongs to data
        shard ``b // lanes_per_shard``, ``batch_spec``'s contiguous
        slots-over-data layout)."""
        flags = [bool(f) for f in busy_flags]
        self.busy_slot_steps += sum(flags)
        lps = self._lanes_per_shard
        for s in range(self._lane_shards):
            self.device_busy_lane_steps[s] += sum(
                flags[s * lps:(s + 1) * lps]
            )

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """A private device copy of a scheduler array.

        ``torch.from_numpy`` would alias the host buffer, which the drain
        mutates in place right after the step is issued; ``torch.tensor``
        always copies.
        """
        return torch.tensor(x, device=self.device)

    def _new_cache(self):
        """A fresh paged cache: this rank's pools under a mesh."""
        return transformer.init_paged_cache(
            self.cfg, self.max_batch, self.max_len, self.block_size,
            self.device, kv_dtype=self.kv_dtype, mesh=self.mesh,
        )

    def _step(self, tokens, cache, positions, block_tables):
        """A decode step: logits (B, 1, vocab_padded), this rank's slots'
        under a mesh."""
        return transformer.decode_step_paged(
            self.params, self.cfg, self._dev(tokens), cache,
            self._dev(positions), self._dev(block_tables),
            block_size=self.block_size, kv_dtype=self.kv_dtype,
            mesh=self.mesh,
        )

    def _decode(self, tokens, cache):
        """A wave step over the dense cache: logits (B, 1, vocab_padded)."""
        return transformer.decode_step(self.params, self.cfg,
                                       self._dev(tokens), cache)

    def _prefill(self, tokens, cache, positions, block_tables, lengths):
        """A chunk step: logits (B, 1, vocab_padded) of each slot's last
        fed row (row 0 for a slot fed nothing), this rank's slots' under
        a mesh."""
        return transformer.prefill_step_paged(
            self.params, self.cfg, self._dev(tokens), cache,
            self._dev(positions), self._dev(block_tables),
            self._dev(lengths), block_size=self.block_size,
            kv_dtype=self.kv_dtype,
            last_rows=self._dev(np.maximum(lengths - 1, 0)),
            mesh=self.mesh,
        )

    def _verify(self, tokens, cache, positions, block_tables, lengths):
        """A chunk step that returns every row's logits (B, w,
        vocab_padded), this rank's slots' under a mesh: speculative
        verification reads all of them."""
        return transformer.prefill_step_paged(
            self.params, self.cfg, self._dev(tokens), cache,
            self._dev(positions), self._dev(block_tables),
            self._dev(lengths), block_size=self.block_size,
            kv_dtype=self.kv_dtype, mesh=self.mesh,
        )

    def _select(self, logits: torch.Tensor, reqs, *, offset: int = 0,
                sampler: Optional[SlotSampler] = None) -> np.ndarray:
        """Every slot's tokens (B, w) from ``logits`` (B, w, ...), slot
        ``b``'s row ``i`` with generation index ``len(reqs[b].generated) +
        offset + i`` (the engine's sampler unless ``sampler`` is given).
        Under a mesh this rank selects its slots' and the tokens are
        gathered over ``data``, so every rank holds all of them."""
        sampler = sampler or self._sampler
        own = (slice(0, self.max_batch) if self.mesh is None
               else sharding.local_slots(self.mesh, self.max_batch))
        toks = sampler.select(logits, reqs[own], offset=offset)
        if own != slice(0, self.max_batch):
            toks = self.mesh.gather(toks, "data")
        return toks.cpu().numpy()

    def submit(self, req: Request) -> None:
        horizon = len(req.prompt) + req.max_new_tokens
        if horizon > self.max_len:
            raise RequestTooLong(
                f"request {req.uid}: prompt[{len(req.prompt)}] + "
                f"max_new_tokens[{req.max_new_tokens}] = {horizon} exceeds "
                f"the per-slot cache ({self.max_len} tokens)"
            )
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        req.submitted_s = time.time()
        req.submitted_step = self.steps
        self._submitted_work += horizon
        self.queue.append(req)

    def add_step_hook(self, hook: StepHook) -> None:
        self.step_hooks.append(hook)

    def warmup(self) -> None:
        """Run throwaway steps on a dummy cache before traffic arrives.

        One decode step and, with chunked prefill, one chunk step at every
        bucket width the drain can use (2, 4, ... up to
        ``prefill_chunk``), each feeding no rows; with speculation, the
        ``spec_k + 1`` wide verification step and the draft's step.  All
        block tables point at the null block and the cache is thrown
        away.  A wave engine runs one step of its dense decode on a
        throwaway dense cache.  On CUDA this
        builds and loads the kernel libraries and warms the matmul
        libraries at each width, so the first request's TTFT measures
        scheduling and not set-up.  The dummy cache has the engine's
        ``kv_dtype``, so the quantized steps are the ones warmed.  No-op
        on engine counters.
        """
        B = self.max_batch
        if self.scheduler == "wave":
            cache = transformer.init_cache(self.cfg, B, self.max_len,
                                           self.device)
            logits, _ = self._decode(np.zeros((B, 1), np.int32), cache)
            logits.cpu()
            return
        cache = self._new_cache()
        pos = np.zeros(B, np.int32)
        bt = np.zeros((B, self.max_len // self.block_size), np.int32)
        w = 2
        while self.prefill_chunk > 1:
            w = min(w, self.prefill_chunk)
            logits, _ = self._prefill(np.zeros((B, w), np.int32), cache,
                                      pos, bt, np.zeros(B, np.int32))
            logits.cpu()
            if w == self.prefill_chunk:
                break
            w *= 2
        if self._spec is not None:
            # the spec_k+1 wide verification (a replay runs the chunk step
            # at the same width) and the draft's one-row step
            logits, _ = self._verify(np.zeros((B, self.spec_k + 1), np.int32),
                                     cache, pos, bt, np.zeros(B, np.int32))
            logits.cpu()
            self._spec.warmup(self)
        logits, _ = self._step(np.zeros((B, 1), np.int32), cache, pos, bt)
        logits.cpu()

    def _call_hooks(self, busy: bool) -> bool:
        """Run every step hook; True while any may still deliver work."""
        pending = False
        for hook in self.step_hooks:
            pending = bool(hook(self, busy)) or pending
        return pending

    def _absorb_pool(self, pool: BlockPool) -> None:
        """Fold one drain's block-pool counters into the engine's (each
        ``run_until_drained`` builds a fresh cache and pool)."""
        self.logical_blocks += pool.logical_blocks
        self.physical_blocks += pool.physical_blocks
        self.shared_block_hits += pool.shared_hits
        self.cow_copies += pool.cow_copies

    def _finish(self, req: Request) -> None:
        req.done = True
        if req.finished_s is None:
            req.finished_s = time.time()
        self.completed[req.uid] = req

    def _note_first_token(self, req: Request) -> None:
        if req.first_token_s is None:
            req.first_token_s = time.time()
            req.first_token_step = self.steps  # the call that produced it

    def preempt(self, uid: Optional[int] = None) -> Optional[int]:
        """Evict one in-flight request from its slot.

        The request is requeued at the FRONT of the queue with its
        ``generated`` tokens intact; on re-admission the engine replays
        prompt + generated through the rebuilt cache and only then starts
        appending, so the served stream is unchanged.  Picks ``uid``'s
        slot, or the deepest busy slot (max cache position, lowest slot
        index on ties).  Returns the preempted uid, or None when nothing
        was preemptible.  Only callable from a step hook while the
        continuous scheduler is draining (a wave engine raises).
        """
        live = self._live
        if live is None:
            raise RuntimeError(
                "preempt() is only available from a step hook while the "
                "continuous scheduler is draining"
            )
        slot_req, positions = live["slot_req"], live["positions"]
        if uid is not None:
            picks = [b for b, r in enumerate(slot_req)
                     if r is not None and r.uid == uid]
        else:
            picks = sorted(
                (b for b, r in enumerate(slot_req) if r is not None),
                key=lambda b: (-int(positions[b]), b),
            )
        if not picks:
            return None
        b = picks[0]
        req = slot_req[b]
        # replay budget: the resumed run re-spends prompt + generated steps
        self._submitted_work += len(req.prompt) + req.max_new_tokens
        self._vacate(b)
        self.queue.appendleft(req)
        self.preemptions += 1
        return req.uid

    def _vacate(self, b: int) -> None:
        """Release slot ``b`` of the live drain: its blocks are decref'd in
        table order (a block no other slot holds goes back to the pool,
        LIFO, so the next admission reuses it first; a shared one survives
        under its other referents), and its row is cleared."""
        live = self._live
        table = live["block_tables"][b]
        for blk in table[table != 0]:
            live["pool"].decref(int(blk))
        table[:] = 0
        live["positions"][b] = 0
        live["tokens"][b, :] = 0
        live["slot_req"][b] = None

    # -- wave scheduler (lockstep over a dense cache, the golden baseline) ----

    def _run_wave(self, wave: List[Request]) -> None:
        """Run one wave to its horizon: every slot advances one token a
        fused step over a fresh dense cache, prompts first, until every
        request of the wave is done.  The step hooks run before each step
        with ``busy=True``; what they submit lands in the next wave."""
        B = self.max_batch
        cache = transformer.init_cache(self.cfg, B, self.max_len,
                                       self.device)
        prompt_len = np.array(
            [len(r.prompt) for r in wave] + [1] * (B - len(wave)), np.int32)
        horizon = int(max(len(r.prompt) + r.max_new_tokens for r in wave))
        if horizon > self.max_len:  # unreachable: submit() already rejects
            raise RequestTooLong(f"wave horizon {horizon} > {self.max_len}")
        tokens = np.zeros((B, 1), np.int32)
        for s, r in enumerate(wave):
            tokens[s, 0] = r.prompt[0]
            r.started_s = time.time()
        slots: List[Optional[Request]] = list(wave) + [None] * (B - len(wave))

        for t in range(horizon - 1):
            self._call_hooks(busy=True)  # arrivals land in the NEXT wave
            self._note_busy([r is not None and not r.done for r in slots])
            logits, cache = self._decode(tokens, cache)
            self.steps += 1
            nxt = self._select(logits, slots)[:, 0]
            for s, r in enumerate(wave):
                if r.done:
                    continue
                if t + 1 < prompt_len[s]:
                    tokens[s, 0] = r.prompt[t + 1]  # still consuming prompt
                    continue
                tok = int(nxt[s])
                self._note_first_token(r)
                r.generated.append(tok)
                tokens[s, 0] = tok
                if len(r.generated) >= r.max_new_tokens or tok == r.eos_id:
                    r.done = True
                    r.finished_s = time.time()
            if all(r.done for r in wave):
                break
        for r in wave:
            self._finish(r)

    def _drain_waves(self, max_waves: int) -> None:
        """Admit the queue's first ``max_batch`` requests as a wave, run
        it to its horizon, and repeat until the queue is empty and no
        hook promises more work; raises after ``max_waves`` waves."""
        waves = 0
        idle_spins = 0
        while True:
            pending = self._call_hooks(busy=False)
            if not self.queue:
                if not pending:
                    break
                idle_spins += 1  # hooks promise work; let them deliver
                if idle_spins > _MAX_IDLE_SPINS:
                    raise RuntimeError(
                        "step hooks report pending work but never submit"
                    )
                continue
            idle_spins = 0
            if waves >= max_waves:
                raise RuntimeError("serve loop did not drain")
            wave = [self.queue.popleft()
                    for _ in range(min(self.max_batch, len(self.queue)))]
            self._run_wave(wave)
            waves += 1

    # -- continuous scheduler (per-slot positions, paged blocks) ---------------

    def _drain_continuous(self, max_steps: Optional[int]) -> None:
        """Drain the queue through the slots, one fused step at a time.

        Port of both continuous drains of the reference,
        ``_drain_continuous`` (``prefill_chunk == 1``) and
        ``_drain_continuous_chunked``: the first is the second with chunks
        of one token, which no budget stalls.  Every busy slot feeds its
        known tokens (prompt, then any tokens already generated, i.e. a
        preemption replay) in order: a slot at position ``t0`` with
        ``n_rem`` known tokens left receives ``n_b = min(chunk, n_rem)`` of
        them this step.  Decode slots (``n_rem == 1``) always advance and
        never count against ``prefill_budget``; prefill slots share the
        budget in slot order and stall at ``n_b = 0`` when it runs out, so
        decode never queues behind a long prompt.  A slot appends a new
        token only on the step that consumes its last known token, from
        that token's logits row.  Busy slot-steps count the slots fed this
        step, as the reference counts them (a budget-stalled slot is not
        busy).
        """
        B, bs, C = self.max_batch, self.block_size, self.prefill_chunk
        nb_slot = self.max_len // bs
        cache = self._new_cache()
        positions = np.zeros(B, np.int32)
        block_tables = np.zeros((B, nb_slot), np.int32)  # 0 = null block
        pool = BlockPool(1 + B * nb_slot, bs,
                         share_prefixes=self.share_prefixes)
        slot_req: List[Optional[Request]] = [None] * B
        tokens = np.zeros((B, C), np.int32)
        lengths = np.zeros(B, np.int32)
        reset_mask = np.zeros(B, bool)
        self._live = {
            "positions": positions, "block_tables": block_tables,
            "pool": pool, "slot_req": slot_req, "tokens": tokens,
            "cache": cache,  # updated in place: the step hooks may read it
        }
        idle_spins = 0

        try:
            while True:
                pending = self._call_hooks(
                    busy=any(r is not None for r in slot_req)
                )
                for b in range(B):
                    if slot_req[b] is None and self.queue:
                        r = self.queue.popleft()
                        slot_req[b] = r
                        if r.started_s is None:
                            r.started_s = time.time()
                        positions[b] = 0
                        block_tables[b] = 0
                        reset_mask[b] = True
                if all(r is None for r in slot_req):
                    if not pending:
                        break
                    idle_spins += 1  # hooks promise work; let them deliver
                    if idle_spins > _MAX_IDLE_SPINS:
                        raise RuntimeError(
                            "step hooks report pending work but never submit"
                        )
                    continue
                idle_spins = 0
                # exact occupancy bound: a request holds its slot for at
                # most prompt + max_new - 1 steps unless budget-stalled
                # (replays re-budgeted at preemption), and at least one
                # slot advances every step
                budget = (max_steps if max_steps is not None
                          else self._submitted_work + B)
                if self.steps >= budget:
                    raise RuntimeError("serve loop did not drain")
                # admission: each slot's next known tokens under the
                # per-step prefill budget, and the blocks they land in
                tokens[:] = 0
                lengths[:] = 0
                budget_left = (self.prefill_budget
                               if self.prefill_budget is not None else B * C)
                for b, r in enumerate(slot_req):
                    if r is None:
                        continue
                    t0 = int(positions[b])
                    n_rem = len(r.prompt) + len(r.generated) - t0
                    if n_rem <= 1 or C == 1:
                        n_b = 1  # decode or one token: never budgeted
                    else:
                        n_b = min(C, n_rem, budget_left)
                        budget_left -= n_b
                    if n_b <= 0:
                        continue  # prefill stalled by the budget this step
                    # known tokens t0 .. t0 + n_b: prompt, then generated
                    head = r.prompt[t0:t0 + n_b]
                    tokens[b, :len(head)] = head
                    if len(head) < n_b:
                        g0 = max(t0 - len(r.prompt), 0)
                        tokens[b, len(head):n_b] = (
                            r.generated[g0:g0 + n_b - len(head)])
                    lengths[b] = n_b
                    # with sharing on, acquire() may return another slot's
                    # block holding the same exact prompt chain
                    for j in range(t0 // bs, (t0 + n_b - 1) // bs + 1):
                        if block_tables[b, j] == 0:
                            blk = pool.acquire(r.prompt, j)
                            block_tables[b, j] = blk
                            self.block_history.setdefault(
                                r.uid, []).append(blk)
                    cache = self._copy_on_write(cache, pool, b, r, t0, n_b)
                if self._has_state and reset_mask.any():
                    # admitted slots start from zero recurrent state
                    cache = transformer.reset_paged_slots(cache, reset_mask,
                                                          mesh=self.mesh)
                reset_mask[:] = False

                self._note_busy(lengths > 0)
                # a step where every busy slot decodes runs the one-token
                # step; a step that carries a chunk (or a budget-stalled
                # slot, which must feed nothing) runs the chunk step at the
                # smallest power-of-two width >= the widest chunk
                if all(lengths[b] == 1 for b, r in enumerate(slot_req)
                       if r is not None):
                    logits, cache = self._step(tokens[:, :1], cache,
                                               positions, block_tables)
                else:
                    w = _bucket_width(int(lengths.max()), C)
                    logits, cache = self._prefill(
                        tokens[:, :w], cache, positions, block_tables,
                        lengths)
                self.steps += 1
                nxt = self._select(logits, slot_req)[:, 0]
                for b, r in enumerate(slot_req):
                    if r is None or lengths[b] == 0:
                        continue
                    positions[b] += lengths[b]
                    if positions[b] < len(r.prompt) + len(r.generated):
                        continue  # still prefilling (or replaying)
                    tok = int(nxt[b])
                    self._note_first_token(r)
                    r.generated.append(tok)
                    if (len(r.generated) >= r.max_new_tokens
                            or tok == r.eos_id):
                        self._finish(r)
                        self._vacate(b)
        finally:
            self._absorb_pool(pool)
            self._live = None

    def _copy_on_write(self, cache, pool: BlockPool, b: int, r: Request,
                       t0: int, n_b: int):
        """Before slot ``b`` writes positions ``[t0, t0 + n_b)``: every
        block that receives a generated-token row while other slots still
        reference it is copied to a private block first (prompt rows write
        through: sharers write the same tokens there), and the pool's
        registry forgets any claim on rows a generated token now holds.
        Returns the cache, whose pools are copied in place."""
        bs = self.block_size
        table = self._live["block_tables"][b]
        gen_from = max(t0, len(r.prompt))
        if gen_from >= t0 + n_b:
            return cache
        for j in range(gen_from // bs, (t0 + n_b - 1) // bs + 1):
            old = int(table[j])
            if pool.refcount_of(old) > 1:
                new = pool.cow(old)
                cache = transformer.copy_paged_block(cache, old, new)
                table[j] = new
                self.block_history.setdefault(r.uid, []).append(new)
            pool.note_generated_write(int(table[j]),
                                      max(gen_from, j * bs) % bs)
        return cache

    # -- public ----------------------------------------------------------------

    def run_until_drained(self, max_waves: int = 1000, *,
                          max_steps: Optional[int] = None
                          ) -> Dict[int, Request]:
        """Drain the queue: in waves (at most ``max_waves``) under the
        wave scheduler, else through the continuous drain (speculative
        where a draft is set) with its runaway guard, or ``max_steps``."""
        t0 = time.time()
        if self.scheduler == "wave":
            self._drain_waves(max_waves)
        elif self._spec is not None:
            self._spec.drain(self, max_steps)
        else:
            self._drain_continuous(max_steps)
        self.wall_s += time.time() - t0
        return self.completed

    def stats(self) -> Dict[str, Any]:
        """Serving metrics, with the keys of the reference engine's
        ``stats()``."""
        lat = sorted(
            r.latency_s for r in self.completed.values()
            if r.latency_s is not None
        )
        ttft = sorted(
            r.ttft_s for r in self.completed.values()
            if r.ttft_s is not None
        )
        ttft_steps = sorted(
            r.ttft_steps for r in self.completed.values()
            if r.ttft_steps is not None
        )
        new_tokens = sum(len(r.generated) for r in self.completed.values())
        block_bytes = transformer.paged_block_bytes(self.cfg, self.block_size,
                                                    self.kv_dtype)
        kv_bytes_served = self.logical_blocks * block_bytes
        kv_bytes_stored = self.physical_blocks * block_bytes
        return {
            "scheduler": self.scheduler,
            "prefill_chunk": self.prefill_chunk,
            "prefill_budget": self.prefill_budget,
            "kv_dtype": self.kv_dtype,
            "share_prefixes": self.share_prefixes,
            "mesh": self.mesh_shape,
            "mesh_devices": 1 if self.mesh is None else self.mesh.size,
            "device_lane_utilization": self.device_lane_utilization,
            "spec_adaptive": self.spec_adaptive,
            "requests": len(self.completed),
            "new_tokens": new_tokens,
            "fused_steps": self.steps,
            "busy_slot_steps": self.busy_slot_steps,
            "slot_steps": self.total_slot_steps,
            "slot_utilization": self.slot_utilization,
            "preemptions": self.preemptions,
            "logical_blocks": self.logical_blocks,
            "physical_blocks": self.physical_blocks,
            "shared_block_hits": self.shared_block_hits,
            "cow_copies": self.cow_copies,
            "kv_bytes_served": kv_bytes_served,
            "kv_bytes_stored": kv_bytes_stored,
            "spec_k": self.spec_k,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "rejected_tokens": self.rejected_tokens,
            "draft_steps": self.draft_steps,
            "target_steps": self.steps,
            "acceptance_rate": core_metrics.acceptance_rate(
                self.accepted_tokens, self.drafted_tokens),
            # a model without attention pages no K/V bytes: its ratio
            # falls back to block counts (the ratio is served / stored in
            # any unit)
            "block_dedup_ratio": core_metrics.block_dedup_ratio(
                kv_bytes_served, kv_bytes_stored
            ) if block_bytes > 0 else core_metrics.block_dedup_ratio(
                self.logical_blocks, self.physical_blocks),
            "wall_s": self.wall_s,
            "tok_s": new_tokens / self.wall_s if self.wall_s > 0 else 0.0,
            "p50_latency_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "p95_latency_s": float(np.percentile(lat, 95)) if lat else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else 0.0,
            "ttft_p50_steps": (float(np.percentile(ttft_steps, 50))
                               if ttft_steps else 0.0),
            "ttft_p95_steps": (float(np.percentile(ttft_steps, 95))
                               if ttft_steps else 0.0),
        }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
