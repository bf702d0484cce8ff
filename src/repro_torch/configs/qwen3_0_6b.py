"""qwen3-0.6b — qk_norm + GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-0.6b",
    source="hf:Qwen/Qwen3-8B; hf",
    notes="per-head RMS qk_norm; GQA kv=8; tied embeddings.",
    model=ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151_936,
        qk_norm=True,
        act="silu_gated",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        loss_chunk=512,
        remat="block",
    ),
)
