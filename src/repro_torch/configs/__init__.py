"""Architecture registry (port of ``repro/configs/__init__.py``).

``get_config(arch_id)`` returns the assigned ``ModelConfig``; the port
registers the architectures whose family it builds. The rest of the JAX
package's roster (``ARCH_IDS``) raises ``NotImplementedError`` naming the
ROADMAP item that ports it.
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
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

# The JAX package's roster; the ones not in _MODULES come with their family.
ARCH_IDS = (
    "qwen2.5-14b", "yi-9b", "gemma3-12b", "llama3.2-1b", "moonshot-v1-16b-a3b",
    "mixtral-8x7b", "seamless-m4t-medium", "hymba-1.5b", "rwkv6-1.6b",
    "internvl2-2b",
)


def _module(arch_id: str):
    if arch_id in _MODULES:
        return importlib.import_module(_MODULES[arch_id])
    if arch_id in ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: ROADMAP.md queue 1, item 10(b2) "
            "(the HYBRID, VLM and ENCDEC families) registers it"
        )
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return get_config(arch_id).reduced(**overrides)
