"""Architecture config registry: ``--arch <id>`` resolves here.

The ten LM architectures of ``repro.configs`` and its shape tables, copied
as they are written there (pure data).
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig
from .shapes import SHAPES, SMOKE_SHAPES, ShapeSpec

_ARCH_MODULES = {
    "musicgen-large": "musicgen_large",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma2-9b": "gemma2_9b",
    "granite-3-2b": "granite_3_2b",
    "smollm-360m": "smollm_360m",
    "smollm-135m": "smollm_135m",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCHS = tuple(_ARCH_MODULES)
CNN_ARCHS = ("resnet50", "resnet50-sparse", "vgg16")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """Resolve an LM architecture id to its ModelConfig."""
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"{__name__}.{_ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def get_shape(name: str, smoke: bool = False) -> ShapeSpec:
    return (SMOKE_SHAPES if smoke else SHAPES)[name]


__all__ = ["ARCHS", "CNN_ARCHS", "SHAPES", "SMOKE_SHAPES", "ShapeSpec",
           "get_config", "get_shape"]
