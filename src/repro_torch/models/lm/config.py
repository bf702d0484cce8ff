"""Model configuration covering every assigned architecture family.

One dataclass describes dense, MoE, hybrid (RG-LRU + local attention),
attention-free (RWKV6), audio-backbone and VLM-backbone transformers. The
per-arch files in :mod:`repro_torch.configs` instantiate it with the published
hyperparameters; reduced variants (``cfg.reduced()``) drive the CPU smoke
tests.

The paper's technique enters through ``pim``: any linear projection in the
model can execute through the bit-serial quantized pipeline
(:mod:`repro_torch.core.pim_layers`), which is how the NAND-SPIN dataflow becomes
a first-class feature of an LM serving/training framework rather than a
CNN-only artifact. See DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core.pim_layers import PIMQuantConfig

BlockKind = Literal["attn", "local_attn", "rglru", "rwkv", "cross_attn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024

    # Attention variants
    qkv_bias: bool = False         # qwen1.5
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10_000.0
    local_window: int = 0          # >0 -> sliding-window for local_attn blocks
    logits_softcap: float = 0.0    # grok-style tanh soft-capping (0 = off)
    attn_softcap: float = 0.0

    # Block schedule. Empty -> ["attn"] * n_layers. A pattern shorter than
    # n_layers tiles (recurrentgemma: ("rglru", "rglru", "local_attn")).
    block_pattern: tuple = ()

    # Mixture-of-experts (applies to every FFN when set)
    moe: MoEConfig | None = None

    # Hybrid / SSM substrate
    conv1d_width: int = 4          # temporal conv in RG-LRU blocks
    lru_width: int = 0             # 0 -> d_model
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0            # >0: chunked-parallel WKV (perf path)

    # VLM: insert a cross-attention block every k self-attention layers.
    cross_attn_every: int = 0
    n_image_tokens: int = 0        # stub frontend sequence length

    # Audio backbone: inputs arrive as precomputed frame embeddings.
    embed_inputs: bool = True      # False -> (B, S, d_model) float inputs

    # Activation / norm flavor
    act: str = "silu_gated"        # silu_gated | gelu_gated | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_attn_norm: bool = False   # grok/ gemma style extra norms

    # Numerics
    dtype: str = "bfloat16"        # activations/params compute dtype
    param_dtype: str = "float32"   # master copy

    # The paper's technique (bit-serial quantized projections)
    pim: PIMQuantConfig | None = None
    # Eq.-2 quantization extended to serving state: int8 KV cache with
    # per-(token, head) scales folded into the attention einsums (the
    # dequantized cache is never materialized). Halves decode cache reads.
    kv_quant: bool = False

    # Training-time memory policy
    remat: str = "block"           # none | block | full
    loss_chunk: int = 0            # >0 -> chunked xent over seq (big vocabs)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # -- derived -----------------------------------------------------------

    @property
    def blocks(self) -> tuple:
        """Per-layer block kinds, pattern tiled to n_layers."""
        pat = self.block_pattern or ("attn",)
        out = []
        i = 0
        while len(out) < self.n_layers:
            kind = pat[i % len(pat)]
            # VLM: cross-attn layers are *extra* layers interleaved every k.
            out.append(kind)
            i += 1
        if self.cross_attn_every:
            merged = []
            for j, k in enumerate(out):
                merged.append(k)
                if (j + 1) % self.cross_attn_every == 0:
                    merged.append("cross_attn")
            out = merged[: self.n_layers]
        return tuple(out)

    @property
    def attends_globally(self) -> bool:
        """True if any block is full (unwindowed) self-attention — such archs
        cannot run the 500k-token decode shape (quadratic KV)."""
        return any(b in ("attn", "cross_attn") for b in self.blocks) and not all(
            b in ("rglru", "rwkv", "local_attn", "cross_attn") for b in self.blocks
        )

    @property
    def recurrent(self) -> bool:
        return any(b in ("rglru", "rwkv") for b in self.blocks)

    def n_params(self) -> int:
        """Total parameter count (analytic; matches init exactly)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        hd = self.head_dim
        for kind in self.blocks:
            if kind in ("attn", "local_attn", "cross_attn"):
                qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
                total += qkv + self.n_heads * hd * d + d  # + pre-norm
                if self.qk_norm:
                    total += 2 * hd
                if self.post_attn_norm:
                    total += d
            elif kind == "rglru":
                w = self.lru_width or d
                total += d * 2 * w + self.conv1d_width * w  # in-proj x2 + conv
                total += 2 * w * w // 1 + w * 3  # gates (block-diag approx) + lru params
                total += w * d + d  # out proj + norm
            elif kind == "rwkv":
                total += d * d * 4 + d * 2  # r,k,v,g (time-mix)
                total += d * 64 * 2 + d * 2  # decay lora + token-shift mixes
                total += d * d + d  # output + ln
            # FFN for every block except pure rwkv (rwkv channel-mix differs)
            if kind == "rwkv":
                total += d * self.d_ff + self.d_ff * d + d  # channel-mix + ln
            elif kind in ("attn", "local_attn", "rglru"):
                gated = self.act.endswith("gated")
                per_ffn = d * self.d_ff * (3 if gated else 2)
                if self.moe:
                    total += self.moe.n_experts * per_ffn + d * self.moe.n_experts
                else:
                    total += per_ffn
                total += d  # pre-ffn norm
        total += d  # final norm
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.n_params()
        gated = self.act.endswith("gated")
        per_ffn = self.d_model * self.d_ff * (3 if gated else 2)
        n_ffn_blocks = sum(1 for b in self.blocks if b in ("attn", "local_attn", "rglru"))
        inactive = n_ffn_blocks * per_ffn * (self.moe.n_experts - self.moe.top_k)
        return self.n_params() - inactive

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if not self.cross_attn_every else 6),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            lru_width=128 if self.lru_width else 0,
            rwkv_head_dim=32,
            n_image_tokens=16 if self.n_image_tokens else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            local_window=min(self.local_window, 64) if self.local_window else 0,
            loss_chunk=0,
            remat="none",
        )
        if self.moe:
            small["moe"] = dataclasses.replace(self.moe, n_experts=4, top_k=2)
        small.update(overrides)
        return dataclasses.replace(self, **small)
