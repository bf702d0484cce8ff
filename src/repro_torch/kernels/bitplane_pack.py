"""Bit-plane slice + 32-lane pack: the CUDA kernel's wrapper and its plain
PyTorch version.

``bitplane_pack(q, bits)`` takes integer codes (M, K) int32 and returns the
packed planes (bits, M, ceil(K/32)) as int32 bit patterns, K zero-padded to
a word. A CUDA tensor launches ``csrc/bitplane_pack.cu``; a CPU tensor runs
:func:`bitplane_pack_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitslice

from . import _build

launches = 0


def bitplane_pack_plain(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain PyTorch version: (M, K) codes -> (bits, M, ceil(K/32))."""
    return bitslice.slice_and_pack(q, bits)


_ARGTYPES = {"repro_bitplane_pack": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def bitplane_pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    if q.dim() != 2 or q.dtype != torch.int32:
        raise ValueError(f"want (M, K) int32 codes, got {tuple(q.shape)} "
                         f"{q.dtype}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits={bits}: the kernel packs 1..8 planes")
    if q.device.type == "cpu":
        return bitplane_pack_plain(q, bits)
    if q.device.type != "cuda":
        raise ValueError(f"no bitplane_pack for device {q.device}")
    q = q.contiguous()
    m, k = q.shape
    kw = bitslice.pad_to_lanes(k) // 32
    out = torch.empty((bits, m, kw), dtype=torch.int32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load("bitplane_pack", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_bitplane_pack(q.data_ptr(), out.data_ptr(), m, k, kw,
                                     bits, stream)
    _build.check(lib, rc, "bitplane_pack")
    global launches
    launches += 1
    return out
