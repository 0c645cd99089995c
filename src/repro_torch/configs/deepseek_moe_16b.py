"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed, top-6.

[arXiv:2401.06066; hf]  28L, d_model=2048, 16H (kv=16), expert d_ff=1408,
vocab=102400.  First layer uses a dense FFN (d_ff=10944, per the paper);
remaining 27 layers are MoE.
"""

from repro_torch.configs.base import MoEConfig, ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense FFN of the first layer
    vocab=102400,
    moe=MoEConfig(
        n_routed=64, top_k=6, d_ff_expert=1408, n_shared=2, first_dense=True
    ),
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    moe=MoEConfig(n_routed=8, top_k=2, d_ff_expert=32, n_shared=1, first_dense=True),
    param_dtype="float32",
    compute_dtype="float32",
)
