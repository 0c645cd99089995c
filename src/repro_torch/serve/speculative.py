"""Speculative decoding over the paged KV cache.

Port of ``repro/serve/speculative.py``.  A small draft model proposes up
to ``k`` tokens a busy slot; the target then scores all of them in one
:func:`~repro_torch.models.transformer.prefill_step_paged` call over every
slot's ragged window (``lengths`` per slot), the chunk step chunked
prefill uses.  The longest proposal prefix that matches the target's own
choices (canonical-stream, see :mod:`repro_torch.serve.sampling`) is
accepted, plus the target's one correction token; the rejected suffix is
undone by rewinding the slot's position and decref'ing the tail blocks
that hold only rejected rows.

Draft proposals and target choices read the same per-(request, generation
index) keys, so an accepted token is the token the plain engine emits at
that index, and a rejection defers the index to the next step, where the
same key meets the same logits.  In the reference the verification step
is the decode cell scanned over the window, so the streams are bitwise
the plain engine's.  The port verifies with its parallel chunk step,
whose logits differ from the one-token step's in the last bits, so the
streams are equal wherever no near tie of the logits meets that
difference (the tolerance chunked prefill already has).

Rewind, by cache kind:

* attention rows past the rewound position are hidden by the causal
  position mask and overwritten by the next window; blocks lying entirely
  past the next write position are decref'd back to the pool, and
  ``note_generated_write`` trims every registry key before a speculated
  row is written, so no prefix key can alias one;
* recurrent (SSM/conv) state has absorbed every row and cannot be masked:
  the decoder copies the per-slot state leaves before each verification
  (:func:`~repro_torch.models.transformer.slot_state`), and on a rejection
  restores the copy for the rejected slots and replays their accepted
  tokens through one more chunk step.

The draft must be attention-only: its paged cache (the compute dtype,
never quantized) shares the target's block tables, pool and copy-on-write
schedule.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.models import transformer
from repro_torch.serve.block_pool import BlockPool
from repro_torch.serve.sampling import SlotSampler


class SpeculativeDecoder:
    """Draft model and verification drain for one
    :class:`~repro_torch.serve.engine.ServeEngine`.

    Owns the draft side (config, parameters, the proposal sampler) and the
    speculative drain; the engine's steps, sampler and accounting are
    reached through the ``eng`` handle :meth:`drain` takes.  Under a mesh
    ``draft_params`` are this rank's shards, cut by the target's rules
    (:func:`~repro_torch.models.transformer.shard_params`).
    """

    #: EMA weight of the trailing per-request acceptance rate
    _ALPHA = 0.5
    #: additive re-probe rate of a stream whose width collapsed to 0
    _RECOVERY = 0.125

    def __init__(self, draft_cfg: ModelConfig, draft_params, k: int, *,
                 target_cfg: ModelConfig, block_size: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 adaptive: bool = False):
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        if any(kind != LayerKind.ATTN for kind in draft_cfg.superblock):
            raise ValueError(
                "the draft model must be attention-only: recurrent "
                "(SSM/conv) draft state cannot share the rewind-by-"
                f"masking path, got superblock {draft_cfg.superblock}"
            )
        transformer.check_served(draft_cfg)
        self.cfg = draft_cfg
        self.params = draft_params
        self.k = int(k)
        self.block_size = block_size
        self.adaptive = bool(adaptive)
        # uid -> EMA of the trailing acceptance rate; absent = 1.0
        self._accept_ema = {}
        # proposals must be token ids of both models; target tokens fed to
        # the draft are clamped to its vocab (_clamp)
        self.shared_vocab = min(draft_cfg.vocab, target_cfg.vocab)
        self.sampler = SlotSampler(self.shared_vocab,
                                   temperature=temperature, top_k=top_k,
                                   seed=seed)

    def _draft_width(self, uid: int) -> int:
        """A slot's draft width from its uid's acceptance EMA, in [0, k]
        (always ``k`` unless adaptive).  A collapsed stream re-probes
        through the additive ``_RECOVERY``.  Width changes how far a slot
        drafts, never what verification accepts."""
        if not self.adaptive:
            return self.k
        ema = self._accept_ema.get(uid, 1.0)
        w = int(round(ema * self.k))
        if w <= 0:
            self._accept_ema[uid] = min(1.0, ema + self._RECOVERY)
        return max(0, min(self.k, w))

    def _note_accept(self, uid: int, accepted: int, drafted: int) -> None:
        """Fold one verification window's acceptance into the uid's EMA."""
        if not self.adaptive or drafted <= 0:
            return
        ema = self._accept_ema.get(uid, 1.0)
        self._accept_ema[uid] = (
            (1.0 - self._ALPHA) * ema + self._ALPHA * accepted / drafted
        )

    def _clamp(self, tokens: np.ndarray) -> np.ndarray:
        """Target tokens past the draft's vocab are clamped into it: the
        draft's conditioning degrades and its proposals are rejected more,
        and correctness never depends on them."""
        return np.minimum(tokens, self.cfg.vocab - 1)

    def _new_cache(self, eng):
        return transformer.init_paged_cache(
            self.cfg, eng.max_batch, eng.max_len, self.block_size,
            eng.device, kv_dtype="f32", mesh=eng.mesh)

    def _step(self, eng, tokens, dcache, positions, block_tables, lengths):
        """The draft's one-row chunk step: logits (B, 1, vocab_padded), this
        rank's slots' under a mesh.  Only slots with ``lengths`` 1 commit a
        row."""
        return transformer.prefill_step_paged(
            self.params, self.cfg, eng._dev(self._clamp(tokens)), dcache,
            eng._dev(positions), eng._dev(block_tables), eng._dev(lengths),
            block_size=self.block_size, kv_dtype="f32", mesh=eng.mesh)

    def warmup(self, eng) -> None:
        """One throwaway draft step on a dummy cache (called from
        :meth:`ServeEngine.warmup`, which warms the target side)."""
        B = eng.max_batch
        logits, _ = self._step(
            eng, np.zeros((B, 1), np.int32), self._new_cache(eng),
            np.zeros(B, np.int32),
            np.zeros((B, eng.max_len // self.block_size), np.int32),
            np.zeros(B, np.int32))
        logits.cpu()

    # -- the speculative continuous drain -------------------------------------

    def drain(self, eng, max_steps: Optional[int]) -> None:
        """Continuous drain where a generating slot advances up to ``k+1``
        tokens a target step.

        Each iteration: (1) a slot with known tokens left (prompt, or a
        preemption replay) is fed one of them, as in the plain continuous
        drain; (2) every generating slot gets up to ``k`` sequential draft
        proposals; (3) one target chunk step verifies every slot's window;
        (4) each slot emits its accepted prefix and the target's correction
        token, and the rejected suffix is rewound.  The draft cache is fed
        every committed token: draft round 0 each busy slot's current
        token, later rounds the proposals.
        """
        from repro_torch.serve.engine import _MAX_IDLE_SPINS

        B, bs, k = eng.max_batch, eng.block_size, self.k
        W = k + 1
        nb_slot = eng.max_len // bs
        cache = eng._new_cache()
        dcache = self._new_cache(eng)
        positions = np.zeros(B, np.int32)
        block_tables = np.zeros((B, nb_slot), np.int32)  # 0 = null block
        pool = BlockPool(1 + B * nb_slot, bs,
                         share_prefixes=eng.share_prefixes)
        slot_req = [None] * B
        tokens = np.zeros((B, 1), np.int32)
        reset_mask = np.zeros(B, bool)
        eng._live = {
            "positions": positions, "block_tables": block_tables,
            "pool": pool, "slot_req": slot_req, "tokens": tokens,
            "cache": cache,  # updated in place: the step hooks may read it
        }
        idle_spins = 0

        try:
            while True:
                pending = eng._call_hooks(
                    busy=any(r is not None for r in slot_req))
                for b in range(B):
                    if slot_req[b] is None and eng.queue:
                        r = eng.queue.popleft()
                        slot_req[b] = r
                        if r.started_s is None:
                            r.started_s = time.time()
                        positions[b] = 0
                        block_tables[b] = 0
                        tokens[b, 0] = r.prompt[0]
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
                # a verification step advances every busy slot by >= 1
                # position; a stateful target may spend one more replay
                # call a step, hence the factor 2
                budget = (max_steps if max_steps is not None
                          else 2 * eng._submitted_work + B)
                if eng.steps >= budget:
                    raise RuntimeError("serve loop did not drain")

                # -- plan: each slot's draft width (0 = a known-token feed,
                # or nothing left to speculate on)
                spec_w = np.zeros(B, np.int32)
                reqs = list(slot_req)  # the stream index of this step
                for b, r in enumerate(slot_req):
                    if r is None:
                        continue
                    t = int(positions[b])
                    if len(r.prompt) + len(r.generated) - t == 1:
                        # generating: as far as the token budget, the slot's
                        # cache (the window writes through t + w) and the
                        # adaptive width allow
                        remaining = r.max_new_tokens - len(r.generated)
                        spec_w[b] = max(0, min(self._draft_width(r.uid),
                                               remaining - 1,
                                               eng.max_len - 1 - t))
                any_spec = bool((spec_w > 0).any())

                # -- blocks and copy-on-write for every position this step
                # writes (t .. t + spec_w[b]), in both caches
                for b, r in enumerate(slot_req):
                    if r is None:
                        continue
                    t = int(positions[b])
                    hi = t + int(spec_w[b])
                    for j in range(t // bs, hi // bs + 1):
                        if block_tables[b, j] == 0:
                            blk = pool.acquire(r.prompt, j)
                            block_tables[b, j] = blk
                            eng.block_history.setdefault(r.uid, []).append(
                                blk)
                    gen_from = max(t, len(r.prompt))
                    if gen_from > hi:
                        continue  # a prompt row: sharers write it too
                    for j in range(gen_from // bs, hi // bs + 1):
                        old = int(block_tables[b, j])
                        if pool.refcount_of(old) > 1:
                            new = pool.cow(old)
                            transformer.copy_paged_block(cache, old, new)
                            transformer.copy_paged_block(dcache, old, new)
                            block_tables[b, j] = new
                            eng.block_history.setdefault(r.uid, []).append(
                                new)
                        # speculated rows are generated rows: trim any
                        # registry key claiming them before they are written
                        pool.note_generated_write(
                            int(block_tables[b, j]),
                            max(gen_from, j * bs) % bs)
                if eng._has_state and reset_mask.any():
                    transformer.reset_paged_slots(cache, reset_mask,
                                                  mesh=eng.mesh)
                reset_mask[:] = False
                eng._note_busy(r is not None for r in slot_req)

                # -- draft: sequential one-row proposals.  Round 0 feeds
                # every busy slot's current token; round i >= 1 feeds
                # proposal i-1 at t + i to the slots that drafted it, the
                # last round only committing its row, so on full acceptance
                # the draft cache is complete through t + w.  Proposal i is
                # drawn with generation index gi + i's key.
                drafts = np.zeros((B, k), np.int32)
                d_tokens = tokens.copy()
                d_lens = np.zeros(B, np.int32)
                rounds = int(spec_w.max())
                for i in range(rounds + 1):
                    d_lens[:] = 0
                    for b, r in enumerate(slot_req):
                        if r is None:
                            continue
                        if i == 0:
                            d_lens[b] = 1
                        elif int(spec_w[b]) >= i:
                            d_lens[b] = 1
                            d_tokens[b, 0] = drafts[b, i - 1]
                    dlogits, dcache = self._step(eng, d_tokens, dcache,
                                                 positions + i, block_tables,
                                                 d_lens)
                    eng.draft_steps += 1
                    if i < rounds:
                        di = eng._select(dlogits, reqs, offset=i,
                                         sampler=self.sampler)
                        live = spec_w > i
                        drafts[live, i] = di[live, 0]

                # -- verification: one target chunk step over every slot's
                # ragged window [x_t, d_1 .. d_w]
                pos0 = positions.copy()
                if any_spec:
                    v_tokens = np.zeros((B, W), np.int32)
                    v_lens = np.zeros(B, np.int32)
                    for b, r in enumerate(slot_req):
                        if r is None:
                            continue
                        w_b = int(spec_w[b])
                        v_tokens[b, 0] = tokens[b, 0]
                        v_tokens[b, 1:1 + w_b] = drafts[b, :w_b]
                        v_lens[b] = 1 + w_b
                    snap = (transformer.slot_state(cache)
                            if eng._has_state else None)
                    logits, cache = eng._verify(v_tokens, cache, positions,
                                                block_tables, v_lens)
                else:
                    logits, cache = eng._step(tokens, cache, positions,
                                              block_tables)
                eng.steps += 1
                # row i of slot b is the target's choice for generation
                # index gi + i, valid wherever the proposals through i-1
                # matched
                y = eng._select(logits, reqs)

                # -- acceptance, emission, rewind
                replay_lens = np.zeros(B, np.int32)
                for b, r in enumerate(slot_req):
                    if r is None:
                        continue
                    t = int(positions[b])
                    w_b = int(spec_w[b])
                    if w_b == 0:
                        # plain continuous semantics: consume one known
                        # token or append the one selected
                        positions[b] = t + 1
                        if t + 1 < len(r.prompt):
                            tokens[b, 0] = r.prompt[t + 1]
                            continue
                        gi = t + 1 - len(r.prompt)
                        if gi < len(r.generated):
                            # preemption replay: served already, feed back
                            tokens[b, 0] = r.generated[gi]
                            continue
                        tok = int(y[b, 0])
                        eng._note_first_token(r)
                        r.generated.append(tok)
                        tokens[b, 0] = tok
                        if (len(r.generated) >= r.max_new_tokens
                                or tok == r.eos_id):
                            eng._finish(r)
                            eng._vacate(b)
                        continue
                    # the longest proposal prefix the target agrees with
                    a = 0
                    while a < w_b and int(drafts[b, a]) == int(y[b, a]):
                        a += 1
                    eng.drafted_tokens += w_b
                    eng.accepted_tokens += a
                    eng.rejected_tokens += w_b - a
                    self._note_accept(r.uid, a, w_b)
                    # emit the accepted prefix and the correction token,
                    # stopping at EOS or the budget as one-token decode does
                    emitted = 0
                    finished = False
                    for i in range(a + 1):
                        tok = int(y[b, i])
                        eng._note_first_token(r)
                        r.generated.append(tok)
                        emitted += 1
                        if (len(r.generated) >= r.max_new_tokens
                                or tok == r.eos_id):
                            finished = True
                            break
                    positions[b] = t + emitted
                    if finished:
                        eng._finish(r)
                        eng._vacate(b)
                        continue
                    tokens[b, 0] = int(y[b, emitted - 1])
                    # blocks lying entirely past the next write position
                    # hold only rejected rows: decref them (never free:
                    # sharing may keep them alive elsewhere)
                    p = t + emitted
                    for j in range(p // bs + 1, (t + w_b) // bs + 1):
                        if block_tables[b, j] != 0:
                            pool.decref(int(block_tables[b, j]))
                            block_tables[b, j] = 0
                    if eng._has_state and emitted < w_b + 1:
                        replay_lens[b] = emitted

                # -- stateful rewind: restore the pre-verification state of
                # the rejected slots and replay their accepted tokens
                if replay_lens.any():
                    transformer.restore_slot_state(
                        cache, snap, replay_lens > 0, mesh=eng.mesh)
                    _, cache = eng._prefill(v_tokens, cache, pos0,
                                            block_tables, replay_lens)
                    eng.steps += 1
        finally:
            eng._absorb_pool(pool)
            eng._live = None
