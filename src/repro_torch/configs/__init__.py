"""Architecture registry (port of ``repro/configs/__init__.py``).

``get_config(arch_id)`` returns the assigned ``ModelConfig``;
``ARCH_IDS`` is the roster, the JAX package's ten. The documented shape
skips (``get_skips``) and ``configs/shapes.py`` belong to the
distributed path (ROADMAP.md queue 1, item 11(b)).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return get_config(arch_id).reduced(**overrides)
