"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="granite-3-2b",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
    notes="dense GQA decoder; 32 heads of dim 64.",
    model=ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=49_155,
        act="silu_gated",
        rope_theta=10_000.0,
        tie_embeddings=True,
        loss_chunk=512,
        remat="block",
    ),
)
