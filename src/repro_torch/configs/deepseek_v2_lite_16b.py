"""DeepSeek-V2-Lite (16B) — MLA (kv_lora=512) + fine-grained MoE top-6.

[arXiv:2405.04434; hf]  27L, d_model=2048, 16H, expert d_ff=1408,
vocab=102400.  64 routed experts (HF's V2-Lite) + 2 shared.  MLA dims per
the paper: kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128.  First
layer dense (d_ff=10944).
"""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab=102400,
    moe=MoEConfig(
        n_routed=64, top_k=6, d_ff_expert=1408, n_shared=2, first_dense=True
    ),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    moe=MoEConfig(n_routed=8, top_k=2, d_ff_expert=32, n_shared=1, first_dense=True),
    mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    param_dtype="float32",
    compute_dtype="float32",
)
