"""Architecture registry: every assigned config plus the paper's own task.

``get_config(name)`` returns the full-size ArchConfig; ``--arch <id>`` in
the launchers resolves through this registry.
"""
from __future__ import annotations

import importlib

from repro_torch.models.base import ArchConfig

ARCH_IDS = (
    "gemma2-2b",
    "qwen3-14b",
    "mixtral-8x7b",
    "jamba-1.5-large-398b",
    "musicgen-medium",
    "rwkv6-3b",
    "smollm-360m",
    "paligemma-3b",
    "dbrx-132b",
    "llama3.2-3b",
)

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "qwen3-14b": "qwen3_14b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-3b": "rwkv6_3b",
    "smollm-360m": "smollm_360m",
    "paligemma-3b": "paligemma_3b",
    "dbrx-132b": "dbrx_132b",
    "llama3.2-3b": "llama3_2_3b",
    "interact-meta-mlp": "interact_meta",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def all_configs() -> dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_IDS}
