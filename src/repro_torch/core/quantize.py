"""Quantization primitives from the paper (§4.2, Eqs. 2-3), in PyTorch.

Eq. 2 (min/max affine quantization):
    Q_o = round((Q_i - Q_min) * (2^k - 1) / (Q_max - Q_min))

Dequantization is the affine inverse:  Q_i ~= Q_o * scale + Q_min  with
``scale = (Q_max - Q_min) / (2^k - 1)``.

Eq. 3 (batch normalization) is an affine transform at inference time; it
folds into a (scale, bias) pair.

The dot-product algebra used throughout the bit-serial path: with
``a = qa * sa + ma`` and ``w = qw * sw + mw`` (per-tensor affine),

    sum_k a_k w_k = sa*sw * P + sa*mw * Sa + sw*ma * Sw + K * ma * mw

where ``P = sum_k qa_k qw_k`` is the integer matmul computed bit-serially
(Eq. 1), ``Sa = sum_k qa_k`` and ``Sw = sum_k qw_k`` are cheap marginals.

Codes are bit-exact with the JAX package: ``torch.round`` rounds half to
even like ``jnp.round``, and ``(x - qmin) / scale`` is a true float32
division (never a multiply by a precomputed reciprocal).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Affine quantization parameters for one tensor.

    ``q = round((x - qmin) / scale)``;  ``x ~= q * scale + qmin``.
    """

    scale: torch.Tensor  # 0-d float32, or (E,) for an expert bank
    qmin: torch.Tensor   # 0-d float32 (the paper's Q_min offset), or (E,)
    bits: int = 8

    def to(self, device) -> QuantParams:
        return QuantParams(self.scale.to(device), self.qmin.to(device),
                           self.bits)

    def per_expert(self) -> QuantParams:
        """An expert bank's (E,) scale and qmin viewed as (E, 1, 1), to
        broadcast against (E, rows, columns) tensors."""
        return QuantParams(self.scale.reshape(-1, 1, 1),
                           self.qmin.reshape(-1, 1, 1), self.bits)


def calibrate_minmax(x: torch.Tensor, bits: int, axis=None,
                     per_expert: bool = False) -> QuantParams:
    """Paper Eq. 2 calibration: per-tensor min/max, or per ``axis`` (an int
    or a tuple; scale and qmin keep the reduced dimensions, as the JAX
    package's ``keepdims``). With ``per_expert``, ``x`` is (E, ...) and
    each x[e] is calibrated on itself (the JAX package's ``vmap`` of the
    per-tensor calibration): scale and qmin (E,)."""
    if axis is not None:
        qmin = x.amin(dim=axis, keepdim=True)
        qmax = x.amax(dim=axis, keepdim=True)
    elif per_expert:
        dims = tuple(range(1, x.dim()))
        qmin, qmax = x.amin(dim=dims), x.amax(dim=dims)
    else:
        if x.dim() == 2 and not x.is_contiguous() and x.T.is_contiguous():
            x = x.T    # a transposed weight (a tied head), read in order
        qmin, qmax = torch.aminmax(x)      # one pass over x
    # Guard the degenerate all-constant tensor; scale must stay positive.
    span = torch.clamp_min(qmax - qmin, torch.finfo(torch.float32).tiny)
    # A tensor divisor, not a Python number: CUDA PyTorch divides by a CPU
    # scalar as a multiply by its reciprocal, which can be one ulp off. It is
    # filled on the device, so no host-to-device copy stalls the stream.
    span = span.to(torch.float32)
    scale = span / torch.full_like(span, float(2**bits - 1))
    return QuantParams(scale=scale, qmin=qmin.to(torch.float32), bits=bits)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Eq. 2 forward: float -> unsigned integer codes in [0, 2^bits), int32."""
    # One temporary, rounded and clipped in place (a vocabulary head's
    # codes are 10^8-10^9 elements); the same operations in the same order.
    q = (x.to(torch.float32) - qp.qmin).div_(qp.scale).round_()
    return q.clamp_(0.0, float(2**qp.bits - 1)).to(torch.int32)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return q.to(torch.float32) * qp.scale + qp.qmin


class _STERound(torch.autograd.Function):
    """round() in the forward, the identity in the backward (the
    straight-through estimator, the JAX package's ``_ste_round``)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator, for
    quantization-aware training of the PIM layers.

    Calibration reads ``x.detach()``. The clip is ``minimum(maximum(q, 0),
    2^bits - 1)``, whose gradient is halved where q sits exactly on a bound,
    as ``jnp.clip``'s is; min/max calibration puts the smallest and largest
    element there (``torch.clamp`` would pass the whole gradient). ``x`` is
    taken to float32 before the shift, as JAX promotes a bf16 ``x`` against
    the float32 ``qmin`` (torch would keep bf16), and the result is cast
    back to ``x.dtype``.
    """
    qp = calibrate_minmax(x.detach(), bits, axis=axis)
    q = _STERound.apply((x.to(torch.float32) - qp.qmin) / qp.scale)
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    hi = torch.full((), float(2**bits - 1), dtype=torch.float32,
                    device=x.device)
    q = torch.minimum(torch.maximum(q, lo), hi)
    return (q * qp.scale + qp.qmin).to(x.dtype)


def fold_batchnorm(gamma, beta, mean, var, eps=1e-5):
    """Eq. 3 as an inference-time affine: returns (scale, bias) such that
    ``y = x * scale + bias`` reproduces batch normalization."""
    inv = gamma / torch.sqrt(var + eps)
    return inv, beta - mean * inv


def affine_correction(prod, sa, sw, k, aq: QuantParams, wq: QuantParams):
    """Recover the float dot product from integer pieces (module docstring).

    ``prod`` (..., N) integer P; ``sa`` (..., 1) activation code sums;
    ``sw`` (N,) or broadcastable (..., N) weight code sums; ``k`` the
    contraction length, an int or a broadcastable (..., 1) tensor. A padded
    convolution charges padded taps exactly zero, so near borders ``sw``
    and ``k`` shrink per output position (see ``pim_conv2d``).
    """
    p = prod.to(torch.float32)
    if not isinstance(k, torch.Tensor):   # filled on the device: no copy
        k = torch.full((), float(k), dtype=torch.float32, device=p.device)
    k = k.to(torch.float32)
    return (
        aq.scale * wq.scale * p
        + aq.scale * wq.qmin * sa.to(torch.float32)
        + wq.scale * aq.qmin * sw.to(torch.float32)
        + k * aq.qmin * wq.qmin
    )
