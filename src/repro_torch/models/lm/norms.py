"""Normalization layers (RMSNorm / LayerNorm / QK-norm), pure functions.

Params are plain dicts; compute in float32 then cast back, as the JAX
package does. A bf16 scale promotes to float32 against the float32
activations, as it does in JAX.
"""
from __future__ import annotations

import torch


def init_rmsnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def init_layernorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def init_norm(kind: str, d: int, device=None):
    return init_layernorm(d, device) if kind == "layernorm" \
        else init_rmsnorm(d, device)


def apply_norm(kind: str, p, x, eps: float = 1e-6):
    return layernorm(p, x, eps) if kind == "layernorm" else rmsnorm(p, x, eps)


def qk_head_norm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3-style qk_norm), in float32.

    ``x``: (..., heads, head_dim); ``scale``: (head_dim,).
    """
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
