"""Rotary position embeddings, decode-aware.

``apply_rope(x, positions, theta)`` works for both full-sequence prefill
(positions = arange) and single-token decode (positions = cache length), so
prefill and decode share one code path. The half-split convention of the
JAX package: ``x1, x2`` are the two halves of ``head_dim``, not
interleaved pairs.
"""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) int32 -> (sin, cos) of shape (B, S, head_dim/2)
    float32.

    The frequencies ``theta ** (-i / half)`` are the correctly rounded
    float32 values (the power taken in float64 from the float32 exponent),
    which are the JAX package's: a float32 ``pow`` is one ulp off at some
    ``i``, and one ulp of a frequency moves the angle at position 4096 by
    ~2e-4."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    # A tensor divisor: CUDA divides by a Python number as a multiply by
    # its reciprocal.
    expo = -idx / torch.full((), float(half), device=positions.device)
    freq = torch.pow(float(theta), expo.to(torch.float64)).to(torch.float32)
    ang = positions.to(torch.float32)[..., None] * freq   # (B, S, half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D) -> rotated, same shape and dtype. Rotation in
    float32."""
    sin, cos = rope_angles(positions, x.shape[-1], theta)
    sin = sin[:, :, None, :]   # (B, S, 1, D/2)
    cos = cos[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
