"""Bit-serial matmul (paper Eq. 1): the CUDA kernels' wrappers and their
plain PyTorch versions.

Both return

    P[m, n] = sum_{x, y} 2^(x+y) * popcount(a_x[m, :] & w_y[n, :])

(M, N) int32, wrapping mod 2^32 like the reference's int32 accumulation,
against prepacked weight planes (w_bits, N, KW) int32 bit patterns:

``bitserial_matmul_fused(qa, pw, a_bits, w_bits)`` takes activation codes
(M, K) int32 with K <= 32*KW, sliced and packed inside the kernel; K past
the codes reads as zero.

``bitserial_matmul_packed(pa, pw, a_bits, w_bits)`` takes activation planes
(a_bits, M, KW) int32 bit patterns, packed beforehand.

A CUDA tensor launches ``csrc/bitserial_matmul.cu``; a CPU tensor runs
:func:`bitserial_matmul_fused_plain` or :func:`packed_matmul_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitslice

from . import _build

launches = 0          # bitserial_matmul_fused
packed_launches = 0   # bitserial_matmul_packed

# Bound on the elements of one broadcast AND in the plain versions.
_PLAIN_CHUNK = 1 << 22

_ARGTYPES = {
    "repro_bitserial_matmul_fused": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "repro_bitserial_matmul_packed": [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def packed_matmul_plain(pa: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """Eq. 1 on packed planes: (a_bits, M, KW) x (w_bits, N, KW) -> (M, N)
    int32, summed in int64 and wrapped mod 2^32."""
    a_bits, m, kw = pa.shape
    w_bits, n, _ = pw.shape
    out = torch.empty((m, n), dtype=torch.int64, device=pa.device)
    step = max(1, _PLAIN_CHUNK // max(1, n * kw))
    for r0 in range(0, m, step):
        a = pa[:, r0:r0 + step]
        acc = torch.zeros((a.shape[1], n), dtype=torch.int64, device=pa.device)
        for x in range(a_bits):
            for y in range(w_bits):
                cnt = bitslice.popcount(a[x][:, None, :] & pw[y][None]).sum(-1)
                acc += cnt << (x + y)
        out[r0:r0 + step] = acc
    return bitslice.to_int32_bits(out & 0xFFFFFFFF)


def bitserial_matmul_fused_plain(qa: torch.Tensor, pw: torch.Tensor,
                                 a_bits: int, w_bits: int) -> torch.Tensor:
    """Plain PyTorch version: slice and pack the codes, then Eq. 1."""
    kw = pw.shape[-1]
    qa = torch.nn.functional.pad(qa, (0, kw * 32 - qa.shape[1]))
    return packed_matmul_plain(bitslice.slice_and_pack(qa, a_bits),
                               pw[:w_bits])


def bitserial_matmul_fused(qa: torch.Tensor, pw: torch.Tensor, a_bits: int,
                           w_bits: int) -> torch.Tensor:
    if qa.dim() != 2 or qa.dtype != torch.int32:
        raise ValueError(f"want (M, K) int32 codes, got {tuple(qa.shape)} "
                         f"{qa.dtype}")
    if pw.dim() != 3 or pw.dtype != torch.int32 or pw.shape[0] != w_bits:
        raise ValueError(f"want ({w_bits}, N, KW) int32 planes, got "
                         f"{tuple(pw.shape)} {pw.dtype}")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"<{w_bits}:{a_bits}>: the kernel takes 1..8 bits")
    m, k = qa.shape
    _, n, kw = pw.shape
    if k > kw * 32:
        raise ValueError(f"activation K={k} exceeds packed weight K={kw * 32}")
    if qa.device != pw.device:
        raise ValueError(f"operands on {qa.device} and {pw.device}")
    if qa.device.type == "cpu":
        return bitserial_matmul_fused_plain(qa, pw, a_bits, w_bits)
    if qa.device.type != "cuda":
        raise ValueError(f"no bitserial_matmul for device {qa.device}")
    if m >= 2**31 or n >= 2**31:
        raise ValueError(f"({m}, {n}) output exceeds the kernel's int indices")
    qa, pw = qa.contiguous(), pw.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=qa.device)
    if out.numel() == 0:
        return out
    lib = _build.load("bitserial_matmul", _ARGTYPES)
    with torch.cuda.device(qa.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_bitserial_matmul_fused(
            qa.data_ptr(), pw.data_ptr(), out.data_ptr(), m, n, k, kw, a_bits,
            w_bits, stream)
    _build.check(lib, rc, "bitserial_matmul_fused")
    global launches
    launches += 1
    return out


def bitserial_matmul_packed(pa: torch.Tensor, pw: torch.Tensor, a_bits: int,
                            w_bits: int) -> torch.Tensor:
    if pa.dim() != 3 or pa.dtype != torch.int32 or pa.shape[0] != a_bits:
        raise ValueError(f"want ({a_bits}, M, KW) int32 planes, got "
                         f"{tuple(pa.shape)} {pa.dtype}")
    if pw.dim() != 3 or pw.dtype != torch.int32 or pw.shape[0] != w_bits:
        raise ValueError(f"want ({w_bits}, N, KW) int32 planes, got "
                         f"{tuple(pw.shape)} {pw.dtype}")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"<{w_bits}:{a_bits}>: the kernel takes 1..8 bits")
    _, m, kw = pa.shape
    _, n, pkw = pw.shape
    if kw != pkw:
        raise ValueError(f"activation words {kw} != weight words {pkw}")
    if pa.device != pw.device:
        raise ValueError(f"operands on {pa.device} and {pw.device}")
    if pa.device.type == "cpu":
        return packed_matmul_plain(pa, pw)
    if pa.device.type != "cuda":
        raise ValueError(f"no bitserial_matmul_packed for device {pa.device}")
    if m >= 2**31 or n >= 2**31 or kw * 32 >= 2**31:
        raise ValueError(f"({m}, {n}, {kw}) exceeds the kernel's int indices")
    pa, pw = pa.contiguous(), pw.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=pa.device)
    if out.numel() == 0:
        return out
    lib = _build.load("bitserial_matmul", _ARGTYPES)
    with torch.cuda.device(pa.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_bitserial_matmul_packed(
            pa.data_ptr(), pw.data_ptr(), out.data_ptr(), m, n, kw, a_bits,
            w_bits, stream)
    _build.check(lib, rc, "bitserial_matmul_packed")
    global packed_launches
    packed_launches += 1
    return out
