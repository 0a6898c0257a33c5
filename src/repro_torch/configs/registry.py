"""``--arch`` id → ModelConfig registry: every arch of the JAX package's."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "nemotron-4-15b": "nemotron_4_15b",
    "deepseek-67b": "deepseek_67b",
    "qwen2.5-3b": "qwen2_5_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-large-v3": "whisper_large_v3",
    "paligemma-3b": "paligemma_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-1.3b": "mamba2_1_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    """The config of an arch; an arch the registry does not hold raises."""
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; ported: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}").CONFIG
