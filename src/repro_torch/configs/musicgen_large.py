"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec tokenizer/codebook-interleaving frontend is a
STUB — inputs arrive as precomputed frame embeddings (B, S, d_model)
(``embed_inputs=False``), per the assignment. MHA (kv=32), plain GELU FFN,
LayerNorm — the original is a standard pre-norm transformer decoder.
"""
from repro_torch.models.lm.config import ModelConfig

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="musicgen-large",
    source="arXiv:2306.05284; hf",
    notes="audio backbone; frame-embedding stub frontend; vocab = 2048 codes.",
    model=ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=2048,
        embed_inputs=False,
        act="gelu",
        norm="layernorm",
        rope_theta=10_000.0,
        remat="block",
    ),
)
