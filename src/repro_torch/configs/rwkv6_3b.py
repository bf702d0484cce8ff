"""rwkv6-3b — Finch, attention-free, data-dependent decay [arXiv:2404.05892; hf].

O(1) decode state per layer ((H, 64, 64) wkv + token-shift vectors) ->
runs the long_500k shape natively.
"""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-3b",
    source="arXiv:2404.05892; hf",
    notes="attention-free linear recurrence; squared-ReLU channel-mix; runs long_500k.",
    model=ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,          # time-mix heads = d_model / rwkv_head_dim
        n_kv_heads=40,
        d_ff=8960,
        vocab=65_536,
        block_pattern=("rwkv",),
        rwkv_head_dim=64,
        rwkv_chunk=16,     # chunked-parallel WKV (exact; §Perf iteration 1)
        norm="layernorm",
        loss_chunk=512,
        remat="block",
    ),
)
