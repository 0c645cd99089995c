"""Mamba-2 370M — pure SSM (SSD / state-space duality), attention-free.

[arXiv:2405.21060; unverified]  48L, d_model=1024, ssm_state=128,
vocab=50280, d_ff=0 (no separate MLP — the Mamba block IS the layer).
"""

from repro_torch.configs.base import LayerKind, ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,  # attention-free; unused
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    layer_pattern=(LayerKind.MAMBA,),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab=256,
    layer_pattern=(LayerKind.MAMBA,),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
    param_dtype="float32",
    compute_dtype="float32",
)
