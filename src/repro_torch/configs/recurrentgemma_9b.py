"""recurrentgemma-9b — RG-LRU + local attention, 2:1 [arXiv:2402.19427; unverified].

The Griffin pattern is two recurrent blocks followed by one local-attention
block; 38 layers = 12 full patterns + 2 trailing recurrent blocks. MQA
(kv=1) with head_dim 256; local window 2048. Sub-quadratic -> runs the
long_500k decode shape (O(1) recurrent state + O(window) ring KV).
"""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma-9b",
    source="arXiv:2402.19427; unverified",
    notes="hybrid RG-LRU/local-attn 2:1; MQA; window 2048; runs long_500k.",
    model=ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256_000,
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=2048,
        lru_width=4096,
        conv1d_width=4,
        act="gelu_gated",
        rope_theta=10_000.0,
        loss_chunk=512,
        remat="block",
    ),
)
