"""Decode-time state: recurrent states as plain dicts of tensors.

Every layer kind owns a state factory; the serving engine keeps one
(max_batch, ...) state on the device across steps and never copies it to
the host. RWKV keeps O(1) decode state: the (H, D, D) WKV matrix and the
two token-shift vectors. The other kinds (KV caches, ring buffers, RG-LRU
states) come with their block kinds (``ROADMAP.md`` Queue 1).
"""
from __future__ import annotations

import torch

from .config import ModelConfig


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
                     device=None):
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, device)
    if kind in ("attn", "local_attn", "cross_attn", "rglru"):
        raise NotImplementedError(
            f"decode state of block kind {kind!r} is not ported yet "
            "(ROADMAP.md Queue 1, the LM zoo)")
    raise ValueError(kind)


def init_model_state(cfg: ModelConfig, batch: int, max_len: int,
                     device=None):
    """Full decode state in the layout of the stacked parameters.

    ``scan``: one tree per unit position whose leaves carry a leading
    (n_reps,) axis, as in the JAX package; ``rest``: per-layer states for
    the remainder layers. ``length`` is (B,): every continuous-batching
    slot decodes at its own position."""
    from .model import layer_plan  # local import to avoid a cycle

    unit, reps, rest = layer_plan(cfg)

    def stacked(kind):
        proto = init_layer_state(kind, cfg, batch, max_len, device)
        return {k: torch.zeros((reps,) + tuple(v.shape), dtype=v.dtype,
                               device=device) for k, v in proto.items()}

    return {
        "scan": [stacked(kind) for kind in unit],
        "rest": [init_layer_state(kind, cfg, batch, max_len, device)
                 for kind in rest],
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
