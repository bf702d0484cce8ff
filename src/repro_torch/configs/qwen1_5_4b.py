"""qwen1.5-4b — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-4b",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    notes="MHA (kv=20) with QKV bias.",
    model=ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab=151_936,
        qkv_bias=True,
        act="silu_gated",
        rope_theta=1_000_000.0,
        loss_chunk=512,
        remat="block",
    ),
)
