"""Architecture registry (port of ``repro.configs``). ``get_config(name)``
returns the full published config; ``get_smoke_config(name)`` a reduced
same-family config for CPU tests."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    TrainConfig,
    reduced,
    shapes_for,
)

ARCH_IDS: List[str] = [
    "llama3-405b",
    "glm4-9b",
    "granite-20b",
    "phi3-mini-3.8b",
    "musicgen-medium",
    "hymba-1.5b",
    "paligemma-3b",
    "rwkv6-3b",
    "qwen2-moe-a2.7b",
    "granite-moe-1b-a400m",
    # the paper's own evaluation platform expressed as a config (GPU sim side)
]

_MODULES: Dict[str, str] = {
    "llama3-405b": "llama3_405b",
    "glm4-9b": "glm4_9b",
    "granite-20b": "granite_20b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "musicgen-medium": "musicgen_medium",
    "hymba-1.5b": "hymba_1_5b",
    "paligemma-3b": "paligemma_3b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
