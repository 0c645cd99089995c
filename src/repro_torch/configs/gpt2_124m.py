"""GPT-2 124M — the paper's own "LLM training / inference (124M)" benchmark.

12L, d_model=768, 12H, vocab=50257, tied embeddings.  d_ff=2048 for the
SwiGLU MLP matches GPT-2's 2x768x3072 MLP parameter count (3x768x2048), so
total params stay ~124M.  LayerNorm as in GPT-2.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gpt2-124m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=2048,
    vocab=50257,
    tie_embeddings=True,
    rms_norm=False,
)

SMOKE = ModelConfig(
    name="gpt2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    tie_embeddings=True,
    rms_norm=False,
    param_dtype="float32",
    compute_dtype="float32",
)
