"""Qwen2.5-14B — dense, GQA kv=8, QKV bias.

[hf:Qwen/Qwen2.5-0.5B family; hf]  48L, d_model=5120, 40H (GQA kv=8),
d_ff=13824, vocab=152064.  NOTE: 40 heads is NOT divisible by the 16-way
``model`` mesh axis — the baseline sharding pads heads 40->48 under GSPMD
(recorded waste; a hillclimb target, see EXPERIMENTS.md §Perf).
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    param_dtype="float32",
    compute_dtype="float32",
)
