"""Bit-plane slice + 32-lane pack: the CUDA kernel's wrapper and its plain
PyTorch version.

``bitplane_pack(q, bits)`` takes integer codes (M, K) int32 and returns the
packed planes (bits, M, ceil(K/32)) as int32 bit patterns, K zero-padded to
a word, for 1 <= bits <= 16 (codes of up to 16 bits, the widest the
paper's precision sweep uses). A CUDA tensor launches
``csrc/bitplane_pack.cu``; a CPU tensor runs :func:`bitplane_pack_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import bitslice

from . import _build

launches = 0

MAX_BITS = 16

_ARGTYPES = {"repro_bitplane_pack": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def bitplane_pack_plain(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain PyTorch version: (M, K) codes -> (bits, M, ceil(K/32))."""
    return bitslice.slice_and_pack(q, bits)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, bound once."""
    return _build.load("bitplane_pack", _ARGTYPES).repro_bitplane_pack


def bitplane_pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    if q.dim() != 2 or q.dtype != torch.int32:
        raise ValueError(f"want (M, K) int32 codes, got {tuple(q.shape)} "
                         f"{q.dtype}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits={bits}: the kernel packs 1..{MAX_BITS} "
                         "planes")
    if not q.is_cuda:
        if q.device.type == "cpu":
            return bitplane_pack_plain(q, bits)
        raise ValueError(f"no bitplane_pack for device {q.device}")
    q = q.contiguous()
    m, k = q.shape
    kw = (k + 31) // 32
    out = q.new_empty((bits, m, kw))
    if not m or not kw:
        return out
    args = (q.data_ptr(), out.data_ptr(), m, k, kw, bits)
    if q.get_device() == torch.cuda.current_device():
        rc = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            rc = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        _build.check(_build.load("bitplane_pack", _ARGTYPES), rc,
                     "bitplane_pack")
    global launches
    launches += 1
    return out
