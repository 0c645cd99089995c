"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf]  72L, d_model=8192, 64H (GQA kv=8), d_ff=24576,
vocab=65536.  Superblock = 8 layers with attention at index 4 (as in the
Jamba paper) and MoE replacing the dense MLP on every other layer.
Adaptation note: Jamba's Mamba-1 mixers are implemented as Mamba-2/SSD
mixers (the SSD dual form); chunk=128 bounds the intra-chunk score tensor
at d_model=8192.
"""

from repro_torch.configs.base import (LayerKind, MoEConfig, ModelConfig,
                                      SSMConfig)

M, A = LayerKind.MAMBA, LayerKind.ATTN

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    layer_pattern=(M, M, M, M, A, M, M, M),
    moe=MoEConfig(n_routed=16, top_k=2, d_ff_expert=24576, moe_every=2,
                  moe_offset=1),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    layer_pattern=(M, M, M, M, A, M, M, M),
    moe=MoEConfig(n_routed=4, top_k=2, d_ff_expert=128, moe_every=2,
                  moe_offset=1),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
    param_dtype="float32",
    compute_dtype="float32",
)
