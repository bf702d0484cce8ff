"""Feed-forward blocks: gated (llama-style) and plain (musicgen-style).

Projections route through ``pim_linear``, so the paper's bit-serial
quantized execution applies to FFNs exactly as it does to attention: at
``<W:I>`` on the ``cuda`` backend every projection is a kernel 2 launch.

``"gelu"`` is the tanh approximation, which is ``jax.nn.gelu``'s default
(``torch.nn.functional.gelu`` defaults to the exact erf form).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.pim_layers import pim_linear

from .config import ModelConfig
from .rwkv6 import randn

_ACTS = {"silu": F.silu,
         "gelu": functools.partial(F.gelu, approximate="tanh")}


def init_mlp(cfg: ModelConfig, generator, device=None):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_in": randn(generator, (d, f), d**-0.5, device),
         "w_out": randn(generator, (f, d), f**-0.5, device)}
    if cfg.act.endswith("gated"):
        p["w_gate"] = randn(generator, (d, f), d**-0.5, device)
    return p


def mlp(p, cfg: ModelConfig, x: torch.Tensor, train: bool = False
        ) -> torch.Tensor:
    act = _ACTS[cfg.act.split("_")[0]]
    h = pim_linear(x, p["w_in"], cfg=cfg.pim, train=train)
    if "w_gate" in p:
        g = pim_linear(x, p["w_gate"], cfg=cfg.pim, train=train)
        h = act(g) * h
    else:
        h = act(h)
    return pim_linear(h, p["w_out"], cfg=cfg.pim, train=train)
