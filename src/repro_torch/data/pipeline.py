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
the reference's batch drawn in the same process.  The ranks of a train
mesh are processes of their own: a ``DataConfig`` made by
:func:`with_role_hashes` carries one process's hashes to them, so that
every rank draws that process's batches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


#: the roles a batch draws
ROLES = ("tokens", "frames", "img")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2  # token distribution skew
    #: (role, hash % 2**31) pairs that stand in for this process's hashes
    role_hashes: Optional[Tuple[Tuple[str, int], ...]] = None


def with_role_hashes(cfg: DataConfig) -> DataConfig:
    """``cfg`` carrying this process's ``hash(role) % 2**31`` of every
    role, which any process then draws with."""
    return dataclasses.replace(cfg, role_hashes=tuple(
        (role, hash(role) % (2**31)) for role in ROLES))


def _rng(cfg: DataConfig, step: int, role: str) -> np.random.Generator:
    h = (dict(cfg.role_hashes)[role] if cfg.role_hashes is not None
         else hash(role) % (2**31))
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step, h]))


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


def rank_rows(batch: Dict[str, Any], data_index: int, n_data: int,
              microbatches: int = 1) -> Dict[str, Any]:
    """Data rank ``data_index``'s rows of a global ``batch`` (every leaf
    split on its leading axis): its :func:`host_slice_for` block of each
    of the ``microbatches`` consecutive microbatches, in order, so that
    its local microbatch i is its block of the global microbatch i (one
    microbatch: its block of the batch).  The rows are those of the
    global draw, the image embeddings' and frames' included (the
    ``host_slice`` of :func:`global_batch` draws its stubs' first rows,
    as the reference's does)."""
    B = next(iter(batch.values())).shape[0]
    if B % (n_data * microbatches):
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatch(es) over {n_data} data rank(s)")
    per_mb = B // microbatches
    rows = np.concatenate([
        np.arange(B)[i * per_mb:(i + 1) * per_mb][
            host_slice_for(data_index, n_data, per_mb)]
        for i in range(microbatches)])
    return {k: v[rows] for k, v in batch.items()}
