"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.models.lm.config import ModelConfig, MoEConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    notes="16 experts top-2, GQA kv=8, SiLU-gated experts.",
    model=ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab=32064,
        moe=MoEConfig(n_experts=16, top_k=2),
        act="silu_gated",
        norm="layernorm",
        rope_theta=10_000.0,
        loss_chunk=512,
        remat="block",
    ),
)
