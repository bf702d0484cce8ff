"""Token samplers: greedy / temperature / top-k, batched, on the device.

Greedy is ``argmax`` (the first of equal maxima, as in JAX). Temperature
sampling draws Gumbel-max, the method of ``jax.random.categorical``, from a
``torch.Generator`` on the logits' device; the draws differ from JAX's for
the same seed, so only greedy tokens can be compared across the packages.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> no truncation


def _prep_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Shared temperature scaling + top-k truncation (both samplers)."""
    l = logits.to(torch.float32) / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(l, cfg.top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, -torch.inf, l)
    return l


def sample(logits: torch.Tensor, cfg: SamplerConfig,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = _prep_logits(logits, cfg)
    u = torch.rand(l.shape, generator=generator, device=l.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(l + gumbel, dim=-1).to(torch.int32)


def sample_per_slot(logits: torch.Tensor, cfg: SamplerConfig,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,); every row draws its own noise, so a
    slot's sample does not depend on the rows around it. The engine's one
    generator advances every step, so no draw is ever replayed."""
    return sample(logits, cfg, generator)
