"""Architecture registry: ``--arch <id>`` -> :class:`ModelConfig`.

Sources are cited per-module; numbers are exactly the brief's assignment.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ModelConfig,
    ShapeConfig,
    SHAPES,
    reduced,
    shape_supported,
)

# arch id -> module name under repro_torch.configs
_MODULES: Dict[str, str] = {
    "olmo-1b": "olmo_1b",
    "qwen3-1.7b": "qwen3_1p7b",
    "deepseek-7b": "deepseek_7b",
    "gemma3-27b": "gemma3_27b",
    "mamba2-130m": "mamba2_130m",
    "kimi-k2-1t-a32b": "kimi_k2",
    "qwen3-moe-235b-a22b": "qwen3_moe",
    "jamba-v0.1-52b": "jamba_52b",
    "whisper-medium": "whisper_medium",
    "internvl2-26b": "internvl2_26b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
