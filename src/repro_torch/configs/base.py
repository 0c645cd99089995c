"""Model/run configuration dataclasses shared by models, configs, launch.

Every assigned architecture is expressed as a ``ModelConfig``.  Layer
heterogeneity (Jamba's 1:7 attn:mamba interleave, DeepSeek's first-dense-then-
MoE) is expressed via a *superblock*: the smallest repeating group of layers.
The transformer core scans over superblocks so HLO size is O(1) in depth.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class LayerKind(str, enum.Enum):
    ATTN = "attn"  # self-attention + FFN (dense or MoE per moe_every)
    MAMBA = "mamba"  # Mamba-2 (SSD) mixer + FFN


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    # apply MoE FFN on layers where (layer_index % moe_every == moe_offset)
    moe_every: int = 1
    moe_offset: int = 0
    first_dense: bool = False  # first layer uses dense FFN (DeepSeek)
    router_dtype: str = "float32"

    @property
    def n_active_experts(self) -> int:
        return self.top_k + self.n_shared


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # norms
    nonparam_ln: bool = False  # OLMo: non-parametric LayerNorm
    rms_norm: bool = True
    norm_eps: float = 1e-5
    # act / ffn
    tie_embeddings: bool = False
    # heterogeneity: one superblock = this many layers, scanned n_layers/len
    layer_pattern: Tuple[LayerKind, ...] = (LayerKind.ATTN,)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    # VLM stub frontend
    n_img_tokens: int = 0
    # positional
    max_position: int = 1 << 20
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # embedding tables are padded so the vocab dim shards over `model`
    # (MaxText-style); loss masks the padded logits.
    vocab_pad_multiple: int = 256
    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    # sub-quadratic? (for long_500k eligibility)
    @property
    def sub_quadratic(self) -> bool:
        return any(k == LayerKind.MAMBA for k in self.layer_pattern)

    @property
    def superblock(self) -> Tuple[LayerKind, ...]:
        return self.layer_pattern

    @property
    def n_superblocks(self) -> int:
        main = self.n_layers - self.enc_layers
        if self.moe is not None and self.moe.first_dense:
            main -= 1
        assert main % len(self.layer_pattern) == 0, (
            f"{self.name}: {main} layers not divisible by superblock "
            f"{len(self.layer_pattern)}"
        )
        return main // len(self.layer_pattern)

    def param_count(self) -> float:
        """Total parameters (embedding included), analytic."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        attn = self._attn_params()
        ffn_dense = 3 * d * self.d_ff  # SwiGLU
        mamba = self._mamba_params()
        n_attn = sum(1 for k in self._full_pattern() if k == LayerKind.ATTN)
        n_mamba = sum(1 for k in self._full_pattern() if k == LayerKind.MAMBA)
        total += n_attn * attn + n_mamba * mamba
        # FFN per layer: MoE or dense
        for i, _ in enumerate(self._full_pattern()):
            if self._is_moe_layer(i):
                m = self.moe
                total += (m.n_routed + m.n_shared) * 3 * d * m.d_ff_expert
                total += d * m.n_routed  # router
            else:
                total += ffn_dense
        # norms (2 per layer) negligible but count
        total += len(self._full_pattern()) * 2 * d + d
        if self.is_encoder_decoder:
            # encoder layers: attn + dense ffn; decoder cross-attn extra
            total += self.enc_layers * (attn + ffn_dense + 2 * d)
            total += (self.n_layers - self.enc_layers) * attn  # cross-attn
        return float(total)

    def active_param_count(self) -> float:
        """Activated parameters per token (MoE-aware), analytic."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        # subtract inactive routed experts on MoE layers
        n_moe_layers = sum(
            1 for i, _ in enumerate(self._full_pattern()) if self._is_moe_layer(i)
        )
        inactive = (m.n_routed - m.top_k) * 3 * d * m.d_ff_expert
        return float(total - n_moe_layers * inactive)

    def _full_pattern(self):
        main = self.n_layers - self.enc_layers
        pat = []
        if self.moe is not None and self.moe.first_dense:
            pat.append(LayerKind.ATTN)
            main -= 1
        reps = main // len(self.layer_pattern)
        pat.extend(list(self.layer_pattern) * reps)
        return pat

    def _is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.first_dense and i == 0:
            return False
        return (i % self.moe.moe_every) == self.moe.moe_offset

    def _attn_params(self) -> float:
        d = self.d_model
        if self.mla is not None:
            ml = self.mla
            qd = self.n_heads * (ml.qk_nope_dim + ml.qk_rope_dim)
            return (
                d * qd  # q proj
                + d * (ml.kv_lora_rank + ml.qk_rope_dim)  # kv down
                + ml.kv_lora_rank * self.n_heads * (ml.qk_nope_dim + ml.v_head_dim)
                + self.n_heads * ml.v_head_dim * d  # o proj
            )
        hd = self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _mamba_params(self) -> float:
        if self.ssm is None:
            return 0.0
        d = self.d_model
        s = self.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        conv_ch = di + 2 * s.n_groups * s.d_state
        in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
        return in_proj + conv_ch * s.d_conv + 2 * nh + di + di * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
