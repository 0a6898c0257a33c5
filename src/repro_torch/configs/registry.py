"""``--arch`` id → ModelConfig registry, limited to the ported archs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    """The config of a ported arch; any other arch raises."""
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; ported: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}").CONFIG
