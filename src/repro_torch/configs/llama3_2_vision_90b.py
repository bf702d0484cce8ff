"""llama-3.2-vision-90b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Backbone only: 100 layers total with a cross-attention layer after every 4
self-attention layers (100 = 20 x (4 self + 1 cross)). The vision tower is
a STUB — cross-attention keys/values come from precomputed patch embeddings
(B, n_image_tokens, d_model) supplied by ``input_specs``.
"""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama-3.2-vision-90b",
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    notes="vlm backbone; patch-embedding stub; zero-init tanh-gated cross-attn.",
    model=ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128_256,
        cross_attn_every=4,
        n_image_tokens=6400,
        act="silu_gated",
        rope_theta=500_000.0,
        loss_chunk=512,
        remat="block",
    ),
)
