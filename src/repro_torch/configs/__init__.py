"""Architecture registry of the PyTorch port.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the same
``ModelConfig`` values as :mod:`repro.configs`, for the architectures the
port runs: every arch of the reference (its six serve archs, the dense
olmo-1b, qwen2.5-14b and qwen3-32b, internvl2-76b behind its
image-embedding stub, and the encoder-decoder whisper-large-v3 behind its
post-conv frame stub).  The reference registry also builds JAX input
specs, so the port keeps its own, free of JAX.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "gpt2-124m": "gpt2_124m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-370m": "mamba2_370m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "olmo-1b": "olmo_1b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-32b": "qwen3_32b",
    "internvl2-76b": "internvl2_76b",
    "whisper-large-v3": "whisper_large_v3",
}

ALL_ARCHS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; the port has {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).FULL


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
