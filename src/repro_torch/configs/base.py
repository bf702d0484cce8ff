"""Arch-config plumbing: the input shapes and the registry's type.

Every ported architecture gets one ``ArchConfig`` binding its published
``ModelConfig`` to its provenance; ``SHAPES`` names the four input shapes
the JAX package's arch configs are defined against.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    model: ModelConfig
    source: str                  # provenance tag from the assignment table
    notes: str = ""
