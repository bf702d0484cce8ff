"""Fused implicit-im2col bit-serial convolution: the CUDA kernel's wrapper
and its plain PyTorch version.

Layouts (built by :func:`repro_torch.kernels.ops.conv2d_bitserial`):

  pa  (a_bits, N*Hp, Wp, CW) — activation codes packed along C (CW words),
      spatial padding applied beforehand with the ZERO code, which ANDs to
      a zero popcount, so patches match the materialized path bit-exactly.
  pw  (KH, w_bits, O, KW, CW) — ``PackedConvWeight.fused_planes``.
  out (N, OH, OW, O) int32 P.

Output row n*OH + oh reads input row n*Hp + oh*stride + kh for kernel row
kh, and output column ow reads word column kw + ow*stride: that index
arithmetic is the whole implicit im2col. A CUDA tensor launches
``csrc/conv2d_fused.cu``; a CPU tensor runs :func:`conv2d_fused_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitslice

from . import _build
from .bitserial_matmul import _PLAIN_CHUNK

launches = 0

_ARGTYPES = {
    "repro_conv2d_fused": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
    + [ctypes.c_void_p],
}


def conv2d_fused_plain(pa: torch.Tensor, pw: torch.Tensor, *, n: int, hp: int,
                       oh: int, ow: int, stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version: gather each (kh, kw) tap's input words, AND
    them with the tap's weight planes and popcount, summed in int64 and
    wrapped mod 2^32."""
    a_bits, _, _, cw = pa.shape
    kh_sz, w_bits, o, kw_sz, _ = pw.shape
    r = torch.arange(n * oh, device=pa.device)
    base = (r // oh) * hp + (r % oh) * stride
    out = torch.empty((n * oh, ow, o), dtype=torch.int64, device=pa.device)
    step = max(1, _PLAIN_CHUNK // max(1, ow * o * cw))
    for r0 in range(0, n * oh, step):
        rows = base[r0:r0 + step]
        acc = torch.zeros((rows.numel(), ow, o), dtype=torch.int64,
                          device=pa.device)
        for kh in range(kh_sz):
            a_rows = pa[:, rows + kh]                     # (a_bits, R, Wp, CW)
            for kw in range(kw_sz):
                a = a_rows[:, :, kw:kw + (ow - 1) * stride + 1:stride]
                for x in range(a_bits):
                    for y in range(w_bits):
                        w = pw[kh, y, :, kw]              # (O, CW)
                        cnt = bitslice.popcount(a[x][..., None, :] & w).sum(-1)
                        acc += cnt << (x + y)
        out[r0:r0 + step] = acc
    return bitslice.to_int32_bits(out & 0xFFFFFFFF).reshape(n, oh, ow, o)


def conv2d_bitserial_fused(pa: torch.Tensor, pw: torch.Tensor, *, n: int,
                           hp: int, oh: int, ow: int,
                           stride: int = 1) -> torch.Tensor:
    """Fused bit-serial conv -> P (N, OH, OW, O) int32."""
    if pa.dim() != 4 or pw.dim() != 5 or pa.dtype != torch.int32 \
            or pw.dtype != torch.int32:
        raise ValueError(f"want int32 planes pa (a_bits, N*Hp, Wp, CW) and pw "
                         f"(KH, w_bits, O, KW, CW), got {tuple(pa.shape)} "
                         f"{pa.dtype}, {tuple(pw.shape)} {pw.dtype}")
    a_bits, rows, wp, cw = pa.shape
    kh_sz, w_bits, o, kw_sz, pcw = pw.shape
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"<{w_bits}:{a_bits}>: the kernel takes 1..8 bits")
    if pcw != cw:
        raise ValueError(f"channel words {cw} != weight words {pcw}")
    if rows != n * hp:
        raise ValueError(f"pa rows {rows} != n*hp {n * hp}")
    if hp < (oh - 1) * stride + kh_sz or wp < (ow - 1) * stride + kw_sz:
        raise ValueError(f"padded map {hp}x{wp} too small for "
                         f"{oh}x{ow} outputs")
    if pa.device != pw.device:
        raise ValueError(f"operands on {pa.device} and {pw.device}")
    if pa.device.type == "cpu":
        return conv2d_fused_plain(pa, pw, n=n, hp=hp, oh=oh, ow=ow,
                                  stride=stride)
    if pa.device.type != "cuda":
        raise ValueError(f"no conv2d_bitserial_fused for device {pa.device}")
    if pa.numel() >= 2**31 or n * oh * ow * o >= 2**31:
        raise ValueError("conv exceeds the kernel's int indices")
    pa, pw = pa.contiguous(), pw.contiguous()
    out = torch.empty((n, oh, ow, o), dtype=torch.int32, device=pa.device)
    if out.numel() == 0:
        return out
    lib = _build.load("conv2d_fused", _ARGTYPES)
    with torch.cuda.device(pa.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_conv2d_fused(
            pa.data_ptr(), pw.data_ptr(), out.data_ptr(), n * oh, rows, hp, oh,
            ow, wp, cw, o, kh_sz, kw_sz, stride, a_bits, w_bits, stream)
    _build.check(lib, rc, "conv2d_bitserial_fused")
    global launches
    launches += 1
    return out
