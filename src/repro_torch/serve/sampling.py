"""Per-slot token selection for the serving engine: greedy or sampled.

Port of ``repro/serve/sampling.py``.  :meth:`SlotSampler.select` takes a
step's logits ``(B, W, vocab_padded)`` and the slot -> request map and
returns the tokens ``(B, W)``: the argmax at ``temperature == 0``,
temperature / top-k sampling otherwise.

Sampling is canonical-stream: the key of a token depends only on ``(seed,
request.uid, generation_index)``, never on the slot, the step or the
scheduler, and is the reference's own threefry key
(:mod:`repro_torch.serve.threefry`), so a request owns one reproducible
stream, the reference's wherever the logits agree.  Speculative decoding
leans on this: the draft proposes with the keys the target verifies with.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.serve import threefry


class SlotSampler:
    """Token selection policy for one engine: vocab, temperature, top-k
    and seed."""

    def __init__(self, vocab: int, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
        if vocab < 1:
            raise ValueError(f"vocab must be >= 1, got {vocab}")
        if temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got {temperature}"
            )
        if top_k < 0:
            raise ValueError(
                f"top_k must be >= 0 (0 = full vocab), got {top_k}"
            )
        self.vocab = int(vocab)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        #: greedy engines skip the uid/index plumbing entirely
        self.greedy = self.temperature == 0.0
        # XLA compiles the reference's ``logits / temperature`` as a
        # multiply by the fp32 reciprocal; a true division differs in the
        # last bit for 9-26% of the logits
        self._inv_t = (None if self.greedy else
                       float(np.float32(1.0) / np.float32(self.temperature)))

    def select(self, rows: torch.Tensor,
               reqs: Sequence[Optional[object]] = (), *,
               offset: int = 0) -> torch.Tensor:
        """One token per logit row of ``rows`` ``(B, W, >= vocab)``: (B, W)
        int64 tokens on ``rows``' device.

        ``reqs`` maps slot -> request (``None`` for an idle slot; any
        object with ``.uid`` and ``.generated``).  Row ``(b, i)`` is
        generation index ``len(reqs[b].generated) + offset + i`` of
        ``reqs[b]`` and draws from ``fold_in(fold_in(PRNGKey(seed), uid),
        index)``, uid and index taken mod 2**32.  Greedy rows are the
        argmax (ties to the lowest index, as ``jnp.argmax``).
        """
        if self.greedy:
            return rows[..., :self.vocab].argmax(dim=-1)
        B, W, _ = rows.shape
        logits = rows[..., :self.vocab].float() * self._inv_t
        if 0 < self.top_k < self.vocab:
            kth = logits.topk(self.top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        uids = np.array([0 if r is None else int(r.uid) for r in reqs],
                        np.int64) & 0xFFFFFFFF
        idx0 = np.array([0 if r is None else len(r.generated) + offset
                         for r in reqs], np.int64)
        dev = rows.device
        flat_u = torch.from_numpy(np.repeat(uids, W)).to(dev)
        flat_i = torch.from_numpy(
            (idx0[:, None] + np.arange(W)[None, :]).reshape(-1)
            & 0xFFFFFFFF).to(dev)
        key = threefry.fold_in(
            threefry.fold_in(threefry.prng_key(self.seed, dev), flat_u),
            flat_i)
        toks = threefry.categorical(key, logits.reshape(B * W, self.vocab))
        return toks.reshape(B, W)
