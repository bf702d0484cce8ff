"""Bit-plane decomposition and lane packing (paper §4.1, Fig. 8).

The paper stores an M-bit matrix as M 1-bit matrices, one per subarray.
Here each 1-bit plane packs 32 elements to a 32-bit word, so one AND plus
one population count evaluates 32 of the paper's sense-amp ANDs.

Layout convention: the *contraction* axis K is packed, i.e. a plane of an
``(..., K)`` integer tensor becomes ``(..., K//32)`` words, and bit ``i`` of
a word is element ``i``. Planes stack on a new leading axis ->
``(bits, ..., K//32)``.

Words are stored as **int32 bit patterns** (the JAX package's uint32 viewed
as int32): CPU PyTorch has no right shift for uint32, and int32 ``>>`` is
arithmetic, so shifts and popcounts of words go through int64 here.
"""
from __future__ import annotations

import torch

LANE_BITS = 32

_LANE_WEIGHTS = [1 << i for i in range(LANE_BITS)]


def pad_to_lanes(k: int) -> int:
    return (k + LANE_BITS - 1) // LANE_BITS * LANE_BITS


def bitplanes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Split non-negative integer codes into 1-bit planes:
    (..., K) -> (bits, ..., K)."""
    shifts = torch.arange(bits, dtype=q.dtype, device=q.device)
    return (q[None] >> shifts.reshape((bits,) + (1,) * q.ndim)) & 1


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def to_uint32_value(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def pack_bits(bit_planes: torch.Tensor) -> torch.Tensor:
    """Pack the trailing axis of 0/1 ints into 32-bit words.

    (..., K) with K % 32 == 0  ->  (..., K // 32) int32 bit patterns.
    """
    k = bit_planes.shape[-1]
    if k % LANE_BITS:
        raise ValueError(f"K={k} must be a multiple of {LANE_BITS}; pad first")
    b = bit_planes.to(torch.int64).reshape(
        *bit_planes.shape[:-1], k // LANE_BITS, LANE_BITS)
    weights = torch.tensor(_LANE_WEIGHTS, dtype=torch.int64, device=b.device)
    return to_int32_bits((b * weights).sum(-1))


def unpack_bits(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., K//32) words -> (..., K) int32."""
    shifts = torch.arange(LANE_BITS, dtype=torch.int64, device=packed.device)
    bits = (to_uint32_value(packed)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * LANE_BITS
                        )[..., :k].to(torch.int32)


# Hacker's Delight's transpose8: the (shift, mask) of its three steps.
_TRANSPOSE8 = ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC),
               (28, 0x00000000F0F0F0F0))


def _transpose8(x: torch.Tensor) -> torch.Tensor:
    """Each int64 as an 8 x 8 bit matrix, transposed: bit i of byte j moves
    to bit j of byte i. Every mask clears the sign bits that the
    arithmetic ``>>`` shifts in."""
    for s, m in _TRANSPOSE8:
        t = (x ^ (x >> s)) & m
        x = x ^ t ^ (t << s)
    return x


def slice_and_pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantized codes (..., K) -> packed planes (bits, ..., ceil(K/32)).

    Pads K up to a lane multiple with zeros (zeros are AND-neutral, so
    padding never perturbs popcount results). The codes go a byte of bits
    at a time: eight lanes' bytes make an int64 whose 8 x 8 bit transpose
    holds plane b of those lanes in its byte b, and a plane's word is the
    four such bytes of its 32 lanes, lowest lanes first (bytes are read in
    the machine's little-endian order). This is ``pack_bits`` of each
    plane ``(q >> b) & 1``, as the JAX package packs, without a 32-bit
    word or an int64 per code and plane.
    """
    k = q.shape[-1]
    kp = pad_to_lanes(k)
    if kp != k:
        q = torch.nn.functional.pad(q, (0, kp - k))
    lead = q.shape[:-1]
    planes = []
    for lo in range(0, bits, 8):
        byte = ((q >> lo) & 0xFF).to(torch.uint8).contiguous()
        x = _transpose8(byte.view(torch.int64))       # 8 lanes an int64
        # (..., KW, 4 lane groups, 8 planes) -> (8 planes, ..., KW, 4)
        by = x.view(torch.uint8).reshape(*lead, kp // LANE_BITS, 4, 8)
        by = by.movedim(-1, 0)[:min(8, bits - lo)].contiguous()
        planes.append(by.view(torch.int32)[..., 0])
    return torch.cat(planes)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 bit patterns -> int64 (SWAR)."""
    x = to_uint32_value(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24
