"""LM substrate of the port: configs, blocks, whole-model entry points and
the modality-frontend stubs.

Block kinds: ``attn`` (the dense GQA decoder: RoPE, qk-norm, QKV bias, the
gated MLP and the KV cache, float or int8), ``local_attn`` and ``rglru``
(the recurrentgemma hybrid), ``cross_attn`` (llama-3.2-vision's gated
cross-attention over stub patch embeddings) and ``rwkv`` (RWKV-6), with a
dense or an MoE FFN (``moe.py``: grok-1, phi3.5-moe). musicgen takes stub
frame embeddings in place of token ids (``embed_inputs=False``)."""
from .config import ModelConfig, MoEConfig
from .model import (
    cast_params,
    decode_step,
    forward,
    init,
    init_state,
    layer_plan,
    loss_fn,
    prefill,
    prefill_into_slot,
    prepack_params,
)
from .stubs import audio_frame_embeddings, image_patch_embeddings

__all__ = [
    "ModelConfig", "MoEConfig", "audio_frame_embeddings", "cast_params",
    "decode_step", "forward", "image_patch_embeddings", "init", "init_state",
    "layer_plan", "loss_fn", "prefill", "prefill_into_slot",
    "prepack_params",
]
