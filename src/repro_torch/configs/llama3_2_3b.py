"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3.2-3b",
    source="hf:meta-llama/Llama-3.2-1B; unverified",
    notes="dense llama3-family GQA decoder.",
    model=ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=128_256,
        act="silu_gated",
        rope_theta=500_000.0,
        tie_embeddings=True,
        loss_chunk=512,
        remat="block",
    ),
)
