"""Grouped-query attention with the variants the ported archs need.

Covers MHA/GQA/MQA (any kv:q ratio), QKV bias (qwen1.5), per-head qk_norm
(qwen3), sliding-window local attention (recurrentgemma), cross-attention
over stub image embeddings behind a zero-init tanh gate
(llama-3.2-vision), attention-logit softcap (grok), and the shared
prefill/decode code path driven by explicit position tensors. The paths
are the self-attention with no cache (``forward``), against the full KV
cache (prefill and decode), against the ring buffer of a ``local_attn``
block (``ring``), and the cross-attention (``kv_src``) with its image cache
or without.

All projections route through :func:`repro_torch.core.pim_layers.
pim_linear`, so an arch config with ``pim`` set executes every QKVO matmul
through the paper's bit-serial pipeline (Eq. 1): kernel 2 on the ``cuda``
backend.

Scores and PV are plain ``torch.matmul``, as the JAX package computes them
(``jnp.einsum`` outside any Pallas kernel). They run in float32 on float32
copies of the operands: the JAX package contracts bf16 operands with float32
accumulation and a float32 result, which a bf16 ``torch.matmul`` would
round to bf16. Each operand is first rounded to the dtype the JAX package
contracts it in, so the products are the same. Softmax runs in float32 with
max-subtraction; masked positions get ``NEG`` rather than -inf, so a fully
masked row gives a uniform softmax, not NaN.
"""
from __future__ import annotations

import torch

from repro_torch.core.pim_layers import pim_linear

from . import cache as C
from .config import ModelConfig
from .norms import qk_head_norm
from .rope import apply_rope
from .rwkv6 import randn

NEG = -2.0**30


def init_attention(cfg: ModelConfig, generator, device=None,
                   cross: bool = False):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d**-0.5
    p = {
        "wq": randn(generator, (d, hq * hd), scale, device),
        "wk": randn(generator, (d, hkv * hd), scale, device),
        "wv": randn(generator, (d, hkv * hd), scale, device),
        "wo": randn(generator, (hq * hd, d), (hq * hd)**-0.5, device),
    }

    def const(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    if cfg.qkv_bias:
        p["bq"] = const(hq * hd, 0.0)
        p["bk"] = const(hkv * hd, 0.0)
        p["bv"] = const(hkv * hd, 0.0)
    if cfg.qk_norm:
        p["q_norm"] = const(hd, 1.0)
        p["k_norm"] = const(hd, 1.0)
    if cross:   # the cross-attention gate (llama-vision's zero-init tanh)
        p["gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   window: int = 0, causal: bool = True) -> torch.Tensor:
    """(B, Sq), (B, Skv) int32 -> (B, 1, Sq, Skv) bool (True = attend)."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k <= q
    if window:
        m &= k > q - window
    return m[:, None, :, :]


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, in float32."""
    return x.to(dtype).to(torch.float32)


def gqa_scores_softmax_v(q, k, v, mask, softcap: float = 0.0,
                         k_scale=None, v_scale=None):
    """Core GQA attention. q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D), mask
    (B,1,Sq,Skv).

    Query head ``h`` reads KV head ``h // G`` (G = Hq / Hkv; the
    repeat-interleave order). int8 KV caches pass per-(token, head)
    ``k_scale``/``v_scale`` ((B, Skv, Hkv) float32): the scales fold into
    the scores and the probabilities, so a dequantized cache is never
    built."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.to(torch.float32) * d**-0.5
    if k.is_floating_point():   # the JAX package contracts q in k's dtype
        qg = _as(qg, k.dtype)
    # (B, Hkv, G*Sq, D) @ (B, Hkv, D, Skv): one batched product per KV head.
    qg = qg.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * sq, d)
    s = torch.matmul(qg, k.to(torch.float32).permute(0, 2, 3, 1))
    s = s.reshape(b, hkv, g, sq, skv)
    if k_scale is not None:   # (B, Skv, Hkv) -> (B, Hkv, 1, 1, Skv)
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[:, :, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = _as(p * v_scale.permute(0, 2, 1)[:, :, None, None, :], q.dtype)
    elif v.is_floating_point():
        p = _as(p, v.dtype)
    o = torch.matmul(p.reshape(b, hkv, g * sq, skv),
                     v.to(torch.float32).permute(0, 2, 1, 3))
    o = o.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4)
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _ring_positions(last: torch.Tensor, wsize: int) -> torch.Tensor:
    """(B, w) position each ring slot holds when ``last`` (B, 1) is the last
    position written: the largest p <= last with p % w == slot (below 0
    for a slot never written)."""
    slot = torch.arange(wsize, dtype=last.dtype, device=last.device)[None]
    return last - torch.remainder(last - slot, wsize)


def _ring_attend(cache: dict, k, v, q_pos, cache_index, window: int):
    """The ring branch: writes the new keys and values into the ring in
    place and returns (k, v, mask) to attend over.

    Decode (one token) writes slot ``index % w`` first, then attends over
    the whole ring. A chunk attends over the ring as it was before the
    chunk (a copy taken first) followed by its own tokens, then writes its
    last ``min(w, S)`` tokens to their ``p % w`` slots: chunked prefill
    starts chunks at offsets above 0, so the window reaches back across the
    chunk boundary. Cached slots with a derived position below 0 were never
    written and are masked."""
    b, sq = k.shape[:2]
    wsize = cache["k"].shape[1]
    dev = k.device
    idx = torch.as_tensor(cache_index, dtype=torch.int32,
                          device=dev).reshape(-1, 1).expand(b, 1)
    if sq == 1:
        C.update_ring_cache(cache, k, v, idx[:, 0])
        k, v = cache["k"], cache["v"]
        kv_pos = _ring_positions(idx, wsize)
    else:
        cached_pos = _ring_positions(idx - 1, wsize)
        k_all = torch.cat([cache["k"].to(k.dtype), k], dim=1)
        v_all = torch.cat([cache["v"].to(v.dtype), v], dim=1)
        take = min(wsize, sq)
        slots = torch.remainder(q_pos[:, -take:], wsize).long()
        bidx = torch.arange(b, device=dev)[:, None]
        cache["k"][bidx, slots] = k[:, -take:].to(cache["k"].dtype)
        cache["v"][bidx, slots] = v[:, -take:].to(cache["v"].dtype)
        k, v = k_all, v_all
        kv_pos = torch.cat([cached_pos, q_pos], dim=1)
    mask = attention_mask(q_pos, kv_pos, window=window)
    mask &= (kv_pos >= 0)[:, None, None, :]
    return k, v, mask


def _cross_write(cache: dict, k, v, cache_index):
    """The cross branch's cache: each sequence whose ``cache_index`` is 0
    (its first prefill; every sequence when the index is None) takes the
    new image keys and values, in place, and every other keeps its own.
    Chosen on the device (``torch.where``), with no read to the host.
    Returns the (k, v) to attend over."""
    b = k.shape[0]
    if cache_index is None:
        write = torch.ones((b,), dtype=torch.bool, device=k.device)
    else:
        write = torch.as_tensor(cache_index, device=k.device).reshape(
            -1).expand(b) == 0
    write = write.reshape(b, 1, 1, 1)
    for name, new in (("k", k), ("v", v)):
        cache[name].copy_(torch.where(write, new.to(cache[name].dtype),
                                      cache[name]))
    return cache["k"], cache["v"]


def attention(p, cfg: ModelConfig, x: torch.Tensor, q_pos: torch.Tensor,
              kv_src=None, cache: dict | None = None, cache_index=None,
              window: int = 0, ring: bool = False, train: bool = False):
    """One attention block. Returns (out (B, Sq, d), the cache | None).

    ``x`` (B, Sq, d); ``q_pos`` (B, Sq) int32; ``window`` > 0 limits each
    query to the last ``window`` positions (``local_attn``). With ``cache``,
    the new keys and values are written into it in place at
    ``cache_index`` (B,) and the queries attend over its first
    ``cache_index + Sq`` rows; with ``ring`` the cache is a ring buffer of
    the last ``w`` tokens (:func:`_ring_attend`).

    With ``kv_src`` (B, Skv, d), the image embeddings, this is
    cross-attention: keys and values are projected from ``kv_src`` at
    every call, without RoPE, and every query attends to every image
    token; with ``cache``, the projection is kept only where
    ``cache_index`` is 0 (:func:`_cross_write`), as the JAX package does.
    A ``gate`` in ``p`` scales the output by ``tanh(gate)``."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, sq, _ = x.shape
    pim = cfg.pim
    kv_in = x if kv_src is None else kv_src
    skv = kv_in.shape[1]

    q = pim_linear(x, p["wq"], p.get("bq"), cfg=pim, train=train).reshape(
        b, sq, hq, hd)
    k = pim_linear(kv_in, p["wk"], p.get("bk"), cfg=pim,
                   train=train).reshape(b, skv, hkv, hd)
    v = pim_linear(kv_in, p["wv"], p.get("bv"), cfg=pim,
                   train=train).reshape(b, skv, hkv, hd)
    if cfg.qk_norm:
        q = qk_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = qk_head_norm(p["k_norm"], k, cfg.norm_eps)
    if kv_src is None:   # RoPE only for self-attention
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)

    scales = {}
    if kv_src is not None:
        if cache is not None:
            k, v = _cross_write(cache, k, v, cache_index)
        mask = torch.ones((b, 1, sq, k.shape[1]), dtype=torch.bool,
                          device=x.device)   # every image token
    elif cache is not None and ring:
        k, v, mask = _ring_attend(cache, k, v, q_pos, cache_index, window)
    elif cache is not None:
        cache = C.update_kv_cache(cache, k, v, cache_index)
        k, v = cache["k"], cache["v"]
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                              device=x.device)[None].expand(b, -1)
        mask = attention_mask(q_pos, kv_pos, window=window)
        valid = torch.as_tensor(cache_index, device=x.device).reshape(
            -1, 1) + sq                                         # (B, 1)
        mask &= (kv_pos < valid)[:, None, None, :]
        if "k_scale" in cache:
            scales = {"k_scale": cache["k_scale"],
                      "v_scale": cache["v_scale"]}
    else:
        mask = attention_mask(q_pos, q_pos, window=window)
    o = gqa_scores_softmax_v(q, k, v, mask, softcap=cfg.attn_softcap,
                             **scales)
    out = pim_linear(o.reshape(b, sq, hq * hd), p["wo"], cfg=pim,
                     train=train)
    if "gate" in p:   # the zero-init cross-attention gate
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out, cache
