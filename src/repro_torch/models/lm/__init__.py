"""LM substrate of the port: configs, blocks and whole-model entry points
(the ``rwkv`` block kind so far)."""
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
