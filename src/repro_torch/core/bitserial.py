"""Bit-serial arithmetic built from AND + bitcount + shift (paper Eq. 1).

    I * W = sum_n sum_m 2^(n+m) * bitcount(AND(c_n(I), c_m(W)))

The port has one execution backend, ``"cuda"``, the counterpart of the JAX
package's ``"pallas"``: the hand-written kernels of
:mod:`repro_torch.kernels` on a CUDA tensor, their plain PyTorch versions
on a CPU tensor. Accumulation is int32 and wraps mod 2^32, as in the
reference.

Weights may arrive as a :class:`repro_torch.core.packed.PackedWeight` — the
deployment path where codes, planes and column sums were computed once at
prepack time (the paper's "program subarrays once").
"""
from __future__ import annotations

import torch

from .packed import PackedWeight, prepack
from .quantize import affine_correction, calibrate_minmax, quantize

BACKENDS = ("cuda",)


def int_matmul_prepacked(qa: torch.Tensor, w: PackedWeight, a_bits: int,
                         backend: str = "cuda") -> torch.Tensor:
    """P = qa @ w.codes from the prepacked weight planes -> (M, N) int32."""
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r} (ported: {BACKENDS})")
    from repro_torch.kernels import ops as _kops

    return _kops.bitserial_matmul(qa, a_bits=a_bits, w_bits=w.bits,
                                  pw=w.planes)


def quantized_matmul(a: torch.Tensor, w, a_bits: int = 8, w_bits: int = 8,
                     backend: str = "cuda") -> torch.Tensor:
    """Full paper pipeline: calibrate -> quantize -> bit-serial P -> dequant.

    ``a`` (..., K) float; ``w`` a (K, N) float weight (quantized per call)
    or a :class:`PackedWeight`.
    """
    lead = a.shape[:-1]
    k = a.shape[-1]
    a2 = a.reshape(-1, k)
    aq = calibrate_minmax(a2, a_bits)
    qa = quantize(a2, aq)
    packed = w if isinstance(w, PackedWeight) else prepack(w, w_bits)
    p = int_matmul_prepacked(qa, packed, a_bits, backend)
    sa = qa.sum(-1, keepdim=True)
    y = affine_correction(p, sa, packed.col_sums, k, aq, packed.wq)
    return y.reshape(*lead, packed.shape[-1])
