"""Real-Gated Linear Recurrent Unit block (RecurrentGemma / Griffin,
arXiv:2402.19427): the recurrent two thirds of the hybrid's pattern.

Recurrence (per channel, float32):

    r_t = sigmoid(W_a x_t + b_a)              recurrence gate
    i_t = sigmoid(W_i x_t + b_i)              input gate
    a_t = exp(c * r_t * log_sigmoid(Lambda))  data-dependent decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates the whole chunk as an inclusive scan over the affine maps
(a_t, b_t), in log depth and in the order of ``jax.lax.associative_scan``'s
odd/even recursion (:func:`affine_scan`), so its float32 products are the
JAX package's own; decode is the O(1) single-step update. The block wraps
the recurrence with a width-4 causal depthwise conv and a GeLU gate branch,
then projects back to d_model.

Only ``w_x``, ``w_gate`` and ``w_out`` route through ``pim_linear`` (kernel
2 at ``<W:I>`` on ``cuda``); the gate products ``x @ w_a`` and ``x @ w_i``
stay float32 ``torch.matmul`` on a float32 copy of the weight, as the JAX
package promotes a bf16 weight against float32 activations. Each leaf is
used in its own dtype: after ``cast_params`` the stacked ``lam``, ``b_a``,
``b_i`` of scanned layers are bf16 and a remainder layer's stay float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.pim_layers import pim_linear

from .config import ModelConfig
from .mlp import _ACTS
from .rwkv6 import randn

_C = 8.0


def init_rglru_block(cfg: ModelConfig, generator, device=None):
    d = cfg.d_model
    w = cfg.lru_width or d
    # Lambda init so that a ~ uniform(0.9, 0.999) at r = 1 (Griffin
    # appendix): softplus^-1 of -log(a) / c.
    u = 0.9 + 0.099 * torch.rand((w,), generator=generator,
                                 device=generator.device)
    lam = torch.log(torch.expm1(-torch.log(u) / _C)).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "w_x": randn(generator, (d, w), d**-0.5, device),
        "w_gate": randn(generator, (d, w), d**-0.5, device),
        "conv": randn(generator, (cfg.conv1d_width, w), 0.1, device),
        "w_a": randn(generator, (w, w), w**-0.5, device),
        "b_a": zeros(w),
        "w_i": randn(generator, (w, w), w**-0.5, device),
        "b_i": zeros(w),
        "lam": lam,
        "w_out": randn(generator, (w, d), w**-0.5, device),
    }


def _causal_conv(p_conv, x: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv, width K. x (B, S, W); state (B, K-1, W) |
    None. Returns (y, the last K-1 inputs) in x's dtype; the taps are cast
    to it and summed in Python's ``sum`` order, as the JAX package does."""
    kw = p_conv.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, S+K-1, W)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * p_conv[i].to(x.dtype) for i in range(kw))
    new_state = xp[:, -(kw - 1):] if kw > 1 else None
    return y, new_state


def _gates(p, x: torch.Tensor):
    """(a, b) of the affine map h -> a h + b, float32. The gate products run
    in float32 on float32 copies of the weights."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf @ p["w_a"].to(torch.float32) + p["b_a"])
    i = torch.sigmoid(xf @ p["w_i"].to(torch.float32) + p["b_i"])
    log_a = _C * r * F.logsigmoid(p["lam"])              # (B, S, W) or (B, W)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 0.0)) \
        * (i * xf)
    return a, b


def _combine(lhs, rhs):
    """The affine maps' composition: rhs after lhs."""
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (``len(even)`` is
    ``len(odd)`` or one more)."""
    shape = list(even.shape)
    shape[1] += odd.shape[1]
    out = torch.empty(shape, dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps (a_t, b_t) along dim 1: the map
    from step 0 to each step t, as (A_t, B_t). The odd/even recursion of
    ``jax.lax.associative_scan``, slice for slice: pairs are combined, the
    half-length sequence is scanned, then the even steps are combined from
    the odd ones. Depth log2(S), any S."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = affine_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                (a[:, 1::2], b[:, 1::2])))
    lhs = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(lhs, (a[:, 2::2], b[:, 2::2]))
    return tuple(_interleave(torch.cat([x[:, :1], e], dim=1), o)
                 for x, e, o in zip((a, b), even, odd))


def rglru_scan(p, x: torch.Tensor, h0: torch.Tensor | None = None):
    """Full-sequence recurrence. x (B, S, W) -> (y in x's dtype, h_last
    float32)."""
    a, b = _gates(p, x)
    if h0 is not None:
        # Fold the carried state into the first step's offset.
        b[:, 0] += a[:, 0] * h0
    _, h = affine_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p, x: torch.Tensor, h_prev: torch.Tensor):
    """One decode step. x (B, W), h_prev (B, W) float32 -> (y, h)."""
    a, b = _gates(p, x)
    h = a * h_prev + b
    return h.to(x.dtype), h


def rglru_block(p, cfg: ModelConfig, x: torch.Tensor,
                state: dict | None = None, train: bool = False):
    """Griffin recurrent block. x (B, S, d) -> (out (B, S, d), new state |
    None). The step path runs for a one-token call with a state (decode,
    and a one-token prefill chunk); every other call scans."""
    gate = _ACTS["gelu"](pim_linear(x, p["w_gate"], cfg=cfg.pim,
                                    train=train))
    h_in = pim_linear(x, p["w_x"], cfg=cfg.pim, train=train)
    conv_state = state["conv"] if state is not None else None
    h_in, new_conv = _causal_conv(p["conv"], h_in, conv_state)
    if state is not None and x.shape[1] == 1:
        y, h_last = rglru_step(p, h_in[:, 0], state["h"])
        y = y[:, None]
    else:
        h0 = state["h"] if state is not None else None
        y, h_last = rglru_scan(p, h_in, h0)
    out = pim_linear(y * gate, p["w_out"], cfg=cfg.pim, train=train)
    new_state = {"conv": new_conv, "h": h_last} if state is not None \
        else None
    return out, new_state
