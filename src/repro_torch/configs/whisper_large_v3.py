"""Whisper-large-v3 — encoder-decoder; the conv frontend is a stub.

[arXiv:2212.04356; unverified]  32 encoder + 32 decoder layers,
d_model=1280, 20H (MHA kv=20, head_dim=64), d_ff=5120, vocab=51866.
Batches carry post-conv frames (B, seq//4, d_model) in place of audio.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=64,  # 32 enc + 32 dec
    enc_layers=32,
    is_encoder_decoder=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    qkv_bias=True,
    rms_norm=False,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=4,
    enc_layers=2,
    is_encoder_decoder=True,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    rms_norm=False,
    param_dtype="float32",
    compute_dtype="float32",
)
