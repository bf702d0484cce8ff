"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified]."""
from repro_torch.models.lm.config import ModelConfig, MoEConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="grok-1-314b",
    source="hf:xai-org/grok-1; unverified",
    notes="MoE 8e top-2; GeGLU; attention/logit soft-capping at 30.",
    model=ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab=131072,
        moe=MoEConfig(n_experts=8, top_k=2),
        act="gelu_gated",
        attn_softcap=30.0,
        logits_softcap=30.0,
        post_attn_norm=True,
        rope_theta=10_000.0,
        loss_chunk=512,
        remat="block",
    ),
)
