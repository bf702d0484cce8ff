"""LM substrate of the port: configs, blocks and whole-model entry points.

Ported block kinds: ``attn`` (the dense GQA decoder: RoPE, qk-norm, QKV
bias, the gated MLP and the KV cache, float or int8), ``local_attn`` and
``rglru`` (the recurrentgemma hybrid) and ``rwkv`` (RWKV-6), with a dense
or an MoE FFN (``moe.py``: grok-1, phi3.5-moe). ``cross_attn`` raises
``NotImplementedError`` (``ROADMAP.md`` Queue 1, item 2)."""
from .config import ModelConfig, MoEConfig
from .model import (
    cast_params,
    decode_step,
    forward,
    init,
    init_state,
    layer_plan,
    prefill,
    prefill_into_slot,
    prepack_params,
)

__all__ = [
    "ModelConfig", "MoEConfig", "cast_params", "decode_step", "forward",
    "init", "init_state", "layer_plan", "prefill", "prefill_into_slot",
    "prepack_params",
]
