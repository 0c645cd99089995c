"""OLMo-1B — dense, non-parametric LayerNorm, MHA.

[arXiv:2402.00838; hf]  16L, d_model=2048, 16H (kv=16 -> MHA), d_ff=8192,
vocab=50304.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    nonparam_ln=True,
    rms_norm=False,
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    nonparam_ln=True,
    rms_norm=False,
    param_dtype="float32",
    compute_dtype="float32",
)
