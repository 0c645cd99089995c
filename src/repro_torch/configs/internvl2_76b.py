"""InternVL2-76B — ViT frontend (stub) + InternLM2-76B dense LM backbone.

[arXiv:2404.16821; unverified]  80L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256.  The InternViT-6B vision tower is a STUB per the
assignment: ``input_specs`` provides precomputed patch embeddings
(B, 256, d_model); text tokens fill the remaining sequence.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    n_img_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    n_img_tokens=8,
    param_dtype="float32",
    compute_dtype="float32",
)
