"""Per-slot token selection for the serving engine: greedy.

Port of the greedy half of ``repro/serve/sampling.py``.  The reference's
sampled streams draw from JAX threefry keys folded from ``(seed, uid,
index)``; they can be held against the reference only once threefry has a
torch port (ROADMAP item 1.13), so ``temperature > 0`` is refused here.
"""

from __future__ import annotations

import torch


class SlotSampler:
    """Token selection policy for one engine."""

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
        if temperature > 0.0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) needs a torch port of "
                "the reference's threefry streams: ROADMAP item 1.13"
            )
        self.vocab = int(vocab)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)

    def select(self, rows: torch.Tensor) -> torch.Tensor:
        """Argmax over the unpadded vocab of every row of ``rows`` (B, W,
        >= vocab): (B, W) int64 tokens on ``rows``' device.  Ties go to
        the lowest index, as in ``jnp.argmax``."""
        return rows[..., :self.vocab].argmax(dim=-1)
