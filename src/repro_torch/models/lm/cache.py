"""Decode-time state: KV caches and recurrent states, as plain dicts of
tensors.

Every layer kind owns a state factory and, where it needs one, an update;
the serving engine keeps one (max_batch, ...) state on the device across
steps and never copies it to the host. ``attn`` blocks keep a KV cache of
(B, max_len, n_kv_heads, head_dim) in the model's dtype, or with
``cfg.kv_quant`` int8 codes plus float32 per-(token, head) scales; an
update writes only the new rows, in place, at each sequence's own offset.
``local_attn`` blocks keep a ring buffer of ``min(local_window, max_len)``
rows, always float (even with ``kv_quant``): decode writes slot ``index %
window`` in place. RWKV and RG-LRU keep O(1) decode state: the (H, D, D)
WKV matrix and the two token-shift vectors, or the RG-LRU's last
``conv1d_width - 1`` conv inputs and its float32 carry ``h``. A
``cross_attn`` block keeps the image keys and values, ``n_image_tokens``
rows, always float (even with ``kv_quant``): they are written once, at a
sequence's first prefill, and read at every later step.
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None,
                  force_float: bool = False):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant and not force_float:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(token, head) int8 codes + float32 scales.

    x (B, S, H, D) -> (codes int8, scale (B, S, H)). Rounds half to even,
    as ``jnp.round`` does, and divides by a device tensor: CUDA divides by
    a Python number as a multiply by its reciprocal, which moves codes."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full((), 127.0, device=x.device) + 1e-30
    q = torch.round(xf / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    index) -> dict:
    """Write (B, S_new, H, D) at per-sequence offsets along the time axis,
    in place, and return ``cache``.

    ``index`` is (B,) (continuous batching: every slot has its own length)
    or a scalar. Only the S_new new rows of each sequence are written (an
    advanced-index assignment), so slots at different positions coexist
    in one decode grid and no step copies the whole cache. A write as long
    as the cache (prefill into a same-length cache, index 0) replaces it
    outright, as the JAX package does."""
    b, s_new = k_new.shape[:2]
    if "k_scale" in cache:   # int8 KV: quantize the update, store scales
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k_new, "v": v_new}
    if s_new == cache["k"].shape[1]:
        for name, val in new.items():
            cache[name].copy_(val)
        return cache
    dev = cache["k"].device
    idx = torch.as_tensor(index, dtype=torch.int64, device=dev)
    rows = idx.reshape(-1, 1).expand(b, 1) + torch.arange(
        s_new, device=dev)[None, :]
    bidx = torch.arange(b, device=dev)[:, None]
    for name, val in new.items():
        cache[name][bidx, rows] = val.to(cache[name].dtype)
    return cache


def init_ring_cache(cfg: ModelConfig, batch: int, window: int,
                    dtype=torch.bfloat16, device=None):
    """Sliding-window KV ring buffer of a ``local_attn`` block (O(window)
    state). Stays float: the window is small and its slots are rewritten
    constantly."""
    return init_kv_cache(cfg, batch, window, dtype=dtype, device=device,
                         force_float=True)


def update_ring_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                      index) -> dict:
    """Write (B, 1, H, D) at each sequence's slot ``index % window``, in
    place, and return ``cache`` (decode)."""
    b = k_new.shape[0]
    window = cache["k"].shape[1]
    dev = cache["k"].device
    idx = torch.as_tensor(index, dtype=torch.int64, device=dev)
    slot = torch.remainder(idx.reshape(-1).expand(b), window)[:, None]
    bidx = torch.arange(b, device=dev)[:, None]
    cache["k"][bidx, slot] = k_new.to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new.to(cache["v"].dtype)
    return cache


def init_rglru_state(cfg: ModelConfig, batch: int, device=None):
    """The conv's last ``conv1d_width - 1`` inputs and the carry ``h``,
    both float32 whatever the model's dtype."""
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=torch.float32, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None):
    """float32 carries, whatever the model's dtype."""
    heads = cfg.d_model // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "tm_shift": zeros(batch, cfg.d_model),   # last token (time-mix)
        "cm_shift": zeros(batch, cfg.d_model),   # last token (channel-mix)
        "wkv": zeros(batch, heads, hd, hd),
    }


def init_layer_state(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     device=None, dtype=torch.bfloat16,
                     n_image_tokens: int = 0):
    if kind == "attn":
        return init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)
    if kind == "local_attn":
        return init_ring_cache(cfg, batch,
                               min(cfg.local_window or max_len, max_len),
                               dtype=dtype, device=device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, device)
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, device)
    if kind == "cross_attn":
        # image KV is written once and reused: quantization buys nothing
        return init_kv_cache(cfg, batch, n_image_tokens or cfg.n_image_tokens,
                             dtype=dtype, device=device, force_float=True)
    raise ValueError(kind)


def init_model_state(cfg: ModelConfig, batch: int, max_len: int,
                     device=None, dtype=torch.bfloat16):
    """Full decode state in the layout of the stacked parameters.

    ``scan``: one tree per unit position whose leaves carry a leading
    (n_reps,) axis, as in the JAX package; ``rest``: per-layer states for
    the remainder layers. ``length`` is (B,): every continuous-batching
    slot decodes at its own position. KV caches take ``dtype``."""
    from .model import layer_plan  # local import to avoid a cycle

    unit, reps, rest = layer_plan(cfg)

    def stacked(kind):
        proto = init_layer_state(kind, cfg, batch, max_len, device, dtype)
        return {k: torch.zeros((reps,) + tuple(v.shape), dtype=v.dtype,
                               device=device) for k, v in proto.items()}

    return {
        "scan": [stacked(kind) for kind in unit],
        "rest": [init_layer_state(kind, cfg, batch, max_len, device, dtype)
                 for kind in rest],
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
