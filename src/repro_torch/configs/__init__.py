"""Config registry: one module per assigned architecture, with the same
values and ``source`` strings as the JAX package's ``repro.configs`` (the
port keeps its own copy and imports nothing of it)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import LONG_CONTEXT_ARCHS, SHAPES, ModelConfig, ShapeConfig, shape_applicable

_ARCH_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen1.5-4b": "qwen1_5_4b",
    "smollm-360m": "smollm_360m",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "dbrx-132b": "dbrx_132b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-large": "musicgen_large",
}

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {name: get_config(name) for name in ARCH_NAMES}


__all__ = [
    "ARCH_NAMES",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_configs",
    "get_config",
    "shape_applicable",
]
