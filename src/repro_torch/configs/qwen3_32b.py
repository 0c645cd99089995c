"""Qwen3-32B — dense, GQA kv=8, qk-norm.

[hf:Qwen/Qwen3-8B family; hf]  64L, d_model=5120, 64H (GQA kv=8),
d_ff=25600, vocab=151936.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qk_norm=True,
    param_dtype="float32",
    compute_dtype="float32",
)
