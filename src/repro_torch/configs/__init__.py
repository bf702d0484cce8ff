"""Configurations of the port: the paper's CNN benchmarks and the ten LM
architectures of the JAX package.

``get_config("<arch-id>")`` returns the published :class:`ArchConfig` of an
architecture; musicgen-large and llama-3.2-vision-90b take their inputs
from the stub frontends (``models/lm/stubs.py``).
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeSpec
from .paper_cnns import CONFIGS, WI_SWEEP, CNNBenchConfig

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "qwen1.5-4b": "qwen1_5_4b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-2b": "granite_3_2b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "grok-1-314b": "grok_1_314b",
    "musicgen-large": "musicgen_large",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "CONFIGS", "SHAPES",
           "WI_SWEEP", "ArchConfig", "CNNBenchConfig", "ShapeSpec",
           "get_config"]
