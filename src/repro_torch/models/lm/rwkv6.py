"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free, data-dependent
decay linear recurrence.

Time-mix per head (head_dim D, state S in float32, key-major layout):

    y_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)          readout
    S_t = diag(w_t) S_{t-1} + k_t v_t^T              state update

with the per-channel decay data-dependent, ``w_t = exp(-exp(w0 + tanh(x_w
@ A) @ B))``, and token-shift interpolation ``lerp(x_t, x_{t-1}, mu)``
feeding each projection. The channel-mix half is the squared-ReLU gated FFN
of the RWKV line.

Prefill of a chunk whose length is a multiple of ``cfg.rwkv_chunk``, and
training, run the chunked WKV, ``kernels.ops.wkv_chunked``: on a CUDA
tensor the hand-written kernel (and its hand-written backward), on a CPU
tensor the plain versions. Other lengths, and
decode, run the rank-1 step token by token. The state is (H, D, D) per
sequence, constant in sequence length.

Types follow the JAX package's promotion: with bf16 parameters
(``model.cast_params``) the decay LoRA, the bonus ``u`` and the group-norm
scale are used in float32 against float32 operands, as JAX promotes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.pim_layers import pim_linear
from repro_torch.kernels import ops

from .config import ModelConfig

_LORA = 64  # decay-LoRA rank (Finch uses 64 for ~3B models)


def randn(generator: torch.Generator, shape, scale: float, device=None):
    """Normal draws from ``generator`` (made on its device), times
    ``scale``, on ``device``."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(device)


def init_rwkv_block(cfg: ModelConfig, generator, device=None):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    heads = d // hd
    s = d**-0.5
    # Decay base: initialized so channels span slow..fast decay (RWKV init).
    ratio = torch.arange(d, dtype=torch.float32, device=device) / max(d - 1, 1)
    w0 = -6.0 + 5.0 * ratio**0.9

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "mu": full((5, d), 0.5),  # token-shift for r, k, v, g, w
        "w_r": randn(generator, (d, d), s, device),
        "w_k": randn(generator, (d, d), s, device),
        "w_v": randn(generator, (d, d), s, device),
        "w_g": randn(generator, (d, d), s, device),
        "w_o": randn(generator, (d, d), s, device),
        "decay_a": randn(generator, (d, _LORA), s, device),
        "decay_b": randn(generator, (_LORA, d), _LORA**-0.5, device),
        "w0": w0,
        "u": full((heads, hd), 0.0),         # bonus for the current token
        "ln_scale": full((heads, hd), 1.0),  # per-head groupnorm
    }


def init_rwkv_channel_mix(cfg: ModelConfig, generator, device=None):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.full((2, d), 0.5, dtype=torch.float32, device=device),
        "w_k": randn(generator, (d, f), d**-0.5, device),
        "w_v": randn(generator, (f, d), f**-0.5, device),
        "w_r": randn(generator, (d, d), d**-0.5, device),
    }


_LOG_W_MIN = -5.0  # decay clamp: keeps exp(-P) < e^80 within a 16-chunk


def _chunked_wkv(r, k, v, w, u, S0, L: int):
    """Chunked-parallel WKV through ``ops.wkv_chunked``.

    r, k, v (B, S, H, D) float32; w (B, S, H, D) in (0, 1); u (H, D); S0
    (B, H, D, D). The log decay is computed as the JAX package's
    ``_chunked_wkv`` computes it, ``max(log(max(w, 1e-38)), -5)``, and the
    heads are laid out as (B*H, S, D) for the kernel: at B = 1 a view, which
    the kernel reads through its strides and whose y it writes back in the
    (B, S, H, D) layout. Returns (y (B, S, H, D), S_final (B, H, D, D)).

    Differentiable: ``ops.wkv_chunked`` is a ``torch.autograd.Function``
    whose backward launches the hand-written backward kernel on a CUDA
    tensor and runs its plain version on the CPU. The log-decay clamp
    stays outside it, in torch ops, whose autograd carries dlw back to w.
    """
    b, s, h, d = r.shape
    lw = torch.clamp_min(torch.log(torch.clamp_min(w, 1e-38)), _LOG_W_MIN)

    def rows(t):  # (B, S, H, D) -> (B*H, S, D)
        return t.permute(0, 2, 1, 3).reshape(b * h, s, d)

    ub = u.to(torch.float32).expand(b, h, d).reshape(b * h, d)
    y, s_last = ops.wkv_chunked(rows(r), rows(k), rows(v), rows(lw), ub,
                                S0.reshape(b * h, d, d), chunk=L)
    return (y.reshape(b, h, s, d).permute(0, 2, 1, 3),
            s_last.reshape(b, h, d, d))


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None):
    """x (B, S, d) -> x_{t-1} (B, S, d); ``prev`` (B, d) carries across
    calls."""
    first = prev[:, None].to(x.dtype) if prev is not None \
        else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _heads(x, heads, hd):
    return x.reshape(*x.shape[:-1], heads, hd)


def _group_norm(x, scale, eps):
    """Per-head RMS-style groupnorm over head_dim; x (..., H, D) float32."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


def rwkv_time_mix(p, cfg: ModelConfig, x: torch.Tensor,
                  state: dict | None = None, train: bool = False):
    """x (B, S, d) -> (y (B, S, d), new_state). float32 recurrence."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    heads = d // hd
    prev_tok = state["tm_shift"] if state is not None else None
    xp = _token_shift(x, prev_tok)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xp - x) * mu[i] for i in range(5))

    r, k, v = (_heads(pim_linear(xi, p[name], cfg=cfg.pim, train=train),
                      heads, hd)
               for xi, name in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = F.silu(pim_linear(xg, p["w_g"], cfg=cfg.pim, train=train))
    # Data-dependent per-channel decay (the Finch contribution), clamped at
    # -5/step in both execution paths (see _chunked_wkv). JAX promotes the
    # bf16 LoRA factors to float32 against the float32 input.
    f32 = torch.float32
    dd = torch.tanh(xw.to(f32) @ p["decay_a"].to(f32)) @ p["decay_b"].to(f32)
    w = torch.exp(torch.clamp_min(-torch.exp(p["w0"] + dd), _LOG_W_MIN))
    w = _heads(w, heads, hd)

    r32, k32, v32 = (t.to(f32) for t in (r, k, v))
    u = p["u"]

    S0 = state["wkv"] if state is not None else torch.zeros(
        (b, heads, hd, hd), dtype=f32, device=x.device)
    chunk = cfg.rwkv_chunk
    if chunk and s % chunk == 0 and s > 1:
        y, S_last = _chunked_wkv(r32, k32, v32, w, u, S0, chunk)
    else:
        S, ys = S0, []
        for t in range(s):
            r_t, k_t, v_t, w_t = r32[:, t], k32[:, t], v32[:, t], w[:, t]
            kv = k_t[..., :, None] * v_t[..., None, :]    # (B,H,D,D) rank-1
            ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                   S + u[..., :, None] * kv))
            S = w_t[..., :, None] * S + kv
        S_last, y = S, torch.stack(ys, dim=1)             # (B,S,H,D)

    y = _group_norm(y, p["ln_scale"], cfg.norm_eps) * g.to(f32).reshape(
        b, s, heads, hd)
    out = pim_linear(y.reshape(b, s, d).to(x.dtype), p["w_o"], cfg=cfg.pim,
                     train=train)
    new_state = None
    if state is not None:
        new_state = dict(state, tm_shift=x[:, -1].to(f32), wkv=S_last)
    return out, new_state


def rwkv_channel_mix(p, cfg: ModelConfig, x: torch.Tensor,
                     state: dict | None = None, train: bool = False):
    prev_tok = state["cm_shift"] if state is not None else None
    xp = _token_shift(x, prev_tok)
    mu = p["mu"].to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    k = pim_linear(xk, p["w_k"], cfg=cfg.pim, train=train)
    k = torch.square(F.relu(k))
    v = pim_linear(k, p["w_v"], cfg=cfg.pim, train=train)
    r = torch.sigmoid(pim_linear(xr, p["w_r"], cfg=cfg.pim, train=train))
    out = r * v
    new_state = dict(state, cm_shift=x[:, -1].to(torch.float32)) \
        if state is not None else None
    return out, new_state
