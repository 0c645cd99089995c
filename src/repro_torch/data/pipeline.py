"""Synthetic, deterministic, *stateless* data pipeline.

Port of ``repro/data/pipeline.py``, in numpy as the reference has it:
batches are a function of (seed, step), so a restart needs to checkpoint
only the integer step, and each host materializes only its slice of the
global batch (``host_slice``).  Token streams are Zipf-distributed; the
VLM's image embeddings and the encoder-decoder's post-conv audio frames are
unit-Gaussian stubs.

Each draw's generator is seeded with ``hash(role) % 2**31``, the
reference's expression.  Python randomizes ``str`` hashes per process, so
a batch is a pure function of (seed, step) within one process, and equals
the reference's batch drawn in the same process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2  # token distribution skew


def _rng(cfg: DataConfig, step: int, role: str) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, hash(role) % (2**31)])
    )


def _tokens(rng, shape, vocab: int, a: float) -> np.ndarray:
    z = rng.zipf(a, size=shape).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def global_batch(
    model_cfg: ModelConfig,
    shape: ShapeConfig,
    data_cfg: DataConfig,
    step: int,
    *,
    host_slice: Optional[slice] = None,
) -> Dict[str, Any]:
    """Materialize (a host's slice of) the training batch for ``step``:
    int32 ``tokens`` and next-token ``labels`` (B, S); for an
    encoder-decoder fp32 ``enc_frames`` (B, max(S // 4, 8), d_model), the
    post-conv frames, beside S decoder tokens; for a VLM fp32
    ``img_embeds`` (B, n_img_tokens, d_model) before S - n_img_tokens
    text tokens."""
    B, S = shape.global_batch, shape.seq_len
    sl = host_slice or slice(0, B)
    nb = sl.stop - sl.start
    out: Dict[str, Any] = {}
    rng = _rng(data_cfg, step, "tokens")
    if model_cfg.is_encoder_decoder:
        s_enc = max(S // 4, 8)
        frames_rng = _rng(data_cfg, step, "frames")
        all_tokens = _tokens(rng, (B, S + 1), model_cfg.vocab,
                             data_cfg.zipf_a)
        out["enc_frames"] = frames_rng.standard_normal(
            (nb, s_enc, model_cfg.d_model), dtype=np.float32)
        out["tokens"] = all_tokens[sl, :-1]
        out["labels"] = all_tokens[sl, 1:]
        return out
    if model_cfg.family == "vlm":
        n_img = model_cfg.n_img_tokens
        s_text = S - n_img
        img_rng = _rng(data_cfg, step, "img")
        all_tokens = _tokens(rng, (B, s_text + 1), model_cfg.vocab,
                             data_cfg.zipf_a)
        out["img_embeds"] = img_rng.standard_normal(
            (nb, n_img, model_cfg.d_model), dtype=np.float32
        )
        out["tokens"] = all_tokens[sl, :-1]
        out["labels"] = all_tokens[sl, 1:]
        return out
    all_tokens = _tokens(rng, (B, S + 1), model_cfg.vocab, data_cfg.zipf_a)
    out["tokens"] = all_tokens[sl, :-1]
    out["labels"] = all_tokens[sl, 1:]
    return out


def host_slice_for(process_index: int, process_count: int,
                   global_batch_size: int) -> slice:
    per = global_batch_size // process_count
    return slice(process_index * per, (process_index + 1) * per)
