"""Configurations of the port: the paper's CNN benchmarks and the LM
architectures ported so far.

``get_config("<arch-id>")`` returns the published :class:`ArchConfig` of a
ported architecture. The JAX package registers ten; the two whose block
kinds are not ported yet (the stub frontends with their cross-attention)
raise a ``KeyError`` that names them as such (``ROADMAP.md`` Queue 1,
item 2).
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
}

# Registered by the JAX package, still to port with their frontends.
NOT_PORTED = ("musicgen-large", "llama-3.2-vision-90b")

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet (its stub "
                       "frontend and cross-attention: ROADMAP.md Queue 1, "
                       f"item 2); ported: {', '.join(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "CONFIGS", "NOT_PORTED", "SHAPES",
           "WI_SWEEP", "ArchConfig", "CNNBenchConfig", "ShapeSpec",
           "get_config"]
