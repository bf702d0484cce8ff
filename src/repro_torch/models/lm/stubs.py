"""Modality-frontend stubs of the vision and audio backbones.

The transformer backbone is the deliverable; the frontend is a stub that
supplies precomputed patch or frame embeddings of the right shapes and
deterministic content, as the JAX package's stubs do: normal draws in
float32 times ``d_model**-0.5``, then cast. Torch's generators draw other
numbers than JAX's keys for the same seed, so tests that compare the two
packages pass the JAX package's arrays in as data.
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def _stub(shape, d_model: int, generator, seed: int, dtype, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * d_model**-0.5).to(device=device, dtype=dtype)


def image_patch_embeddings(cfg: ModelConfig, batch: int, generator=None,
                           dtype=torch.bfloat16, device="cuda"):
    """Stub ViT output: (B, n_image_tokens, d_model), drawn from
    ``generator`` (one seeded 0 on ``device`` where none is given)."""
    return _stub((batch, cfg.n_image_tokens, cfg.d_model), cfg.d_model,
                 generator, 0, dtype, device)


def audio_frame_embeddings(cfg: ModelConfig, batch: int, seq: int,
                           generator=None, dtype=torch.bfloat16,
                           device="cuda"):
    """Stub EnCodec frame embeddings: (B, S, d_model), musicgen's decoder
    input after the codebook-sum embedding stage, drawn from ``generator``
    (one seeded 1 on ``device`` where none is given)."""
    return _stub((batch, seq, cfg.d_model), cfg.d_model, generator, 1,
                 dtype, device)
