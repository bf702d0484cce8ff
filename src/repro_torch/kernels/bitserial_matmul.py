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

``bitserial_matmul_fused_batched(qa, pw, a_bits, w_bits)`` runs E fused
products in one launch: codes (E, M, K) against an expert bank's planes
(E, w_bits, N, KW) -> (E, M, N), what the JAX package's ``vmap`` of the
fused kernel over an MoE bank computes.

A CUDA tensor launches ``csrc/bitserial_matmul.cu`` (u8 codes on the int8
tensor cores) with the launch plan of :func:`_plan`; a CPU tensor runs
:func:`bitserial_matmul_fused_plain`, :func:`packed_matmul_plain` or
:func:`bitserial_matmul_fused_batched_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import bitslice

from . import _build

launches = 0          # bitserial_matmul_fused
packed_launches = 0   # bitserial_matmul_packed
batched_launches = 0  # bitserial_matmul_fused_batched

# Bound on the elements of one float64 operand (or product) of the plain
# versions' bit matmuls.
_PLAIN_CHUNK = 1 << 24

_ARGTYPES = {
    "repro_bitserial_matmul_fused": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "repro_bitserial_matmul_packed": [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "repro_bitserial_matmul_fused_batched": [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    "repro_bitserial_matmul_tile": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}

# The kernel's tiles by variant (its number in the C entry points): rows,
# columns, words of K a pipeline stage. The C library reports its own
# (``repro_bitserial_matmul_tile``); the first launch holds them equal.
SMALL, LARGE = 0, 1
TILES = ((16, 128, 4), (64, 128, 4))
SMALL_M = 16          # M up to this runs the 16-row tile
# Words of K one split may sum: 32,768 K, so its s32 sum of u8 products is
# exact (255^2 * 32,768 < 2^31).
SLAB_WORDS = 1024


class Plan(NamedTuple):
    """How one product is launched: the tile (``SMALL`` or ``LARGE``, an
    index of ``TILES``), and K cut into ``splits`` ranges of ``split_words``
    words (the last one shorter), each summed by its own blocks and added
    to the output with uint32 atomics when ``splits`` > 1."""
    variant: int
    split_words: int
    splits: int


@functools.lru_cache(maxsize=4096)
def _plan(m: int, n: int, kw: int, sms: int, e: int = 1,
          bm: int | None = None, bkw: int | None = None) -> Plan:
    """The launch plan of ``e`` (M, N) products (one, or an expert bank's)
    over KW words of K on a card of ``sms`` SMs: the 16-row tile for M <=
    16, else the 64-row one; K split across blocks until the grid (the
    tiles of all ``e`` products) holds about two blocks per SM (where KW
    has the steps for it), and always into ranges of at most
    ``SLAB_WORDS``; the grid's z (``e`` times the splits) stays within
    65,535.

    ``bm``/``bkw`` are the autotuner's requests (``ops.matmul_tiles``):
    ``bm`` picks the tile (<= 16 rows the 16-row one, else the 64-row
    one), ``bkw`` the words of a split, rounded up to the tile's step and
    capped at ``SLAB_WORDS`` and at K. Without them the plan is the one
    above."""
    small = (m if bm is None else bm) <= SMALL_M
    variant = SMALL if small else LARGE
    tm, tn, kstep = TILES[variant]
    steps = -(-kw // kstep)
    if bkw is None:
        tiles = max(1, e * -(-m // tm) * -(-n // tn))
        splits = max(-(-2 * sms // tiles),
                     -(-steps // (SLAB_WORDS // kstep)))
        per = max(1, -(-steps // max(1, min(splits, steps, 65535 // e))))
    else:
        per = min(max(1, -(-bkw // kstep)), SLAB_WORDS // kstep, steps)
        per = max(per, -(-steps // (65535 // e)))
    return Plan(variant, per * kstep, max(1, -(-steps // per)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plane_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., KW) int32 words -> (..., 32 * KW) float64 0/1: bit j of word w
    at 32 * w + j (``>>`` of an int32 is arithmetic, and ``& 1`` keeps bit
    j alone, the sign bit's too)."""
    shifts = torch.arange(bitslice.LANE_BITS, dtype=torch.int32,
                          device=words.device)
    return ((words[..., None] >> shifts) & 1).flatten(-2).to(torch.float64)


def count_pairs(a: torch.Tensor, w_planes, a_bits: int) -> torch.Tensor:
    """sum_{x, y} 2^(x+y) * popcount(a_x & w_y) in int64, from the bits of
    the activation planes ``a`` (a_bits * R, K) float64 (``plane_bits``,
    plane x's rows at x * R) and the words of the weight planes
    ``w_planes`` (w_bits, C, ...) in the same order: one pair's AND and
    popcount summed over the words is the dot product of the two planes'
    bits, a float64 product of 0/1 matrices, exact while K < 2^53.
    -> (R, C)."""
    shift = torch.arange(a_bits, device=a.device).reshape(a_bits, 1, 1)
    acc = 0
    for y, w in enumerate(w_planes):
        cnt = (a @ plane_bits(w).flatten(1).T).to(torch.int64)
        acc = acc + (cnt.reshape(a_bits, -1, cnt.shape[-1])
                     << (shift + y)).sum(0)
    return acc


def packed_matmul_plain(pa: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """Eq. 1 on packed planes: (a_bits, M, KW) x (w_bits, N, KW) -> (M, N)
    int32, each pair's popcounts counted by ``count_pairs``, summed in int64
    and wrapped mod 2^32."""
    a_bits, m, kw = pa.shape
    _, n, _ = pw.shape
    k = kw * bitslice.LANE_BITS
    out = torch.empty((m, n), dtype=torch.int64, device=pa.device)
    cols = max(1, min(n, _PLAIN_CHUNK // k))
    rows = max(1, min(m, _PLAIN_CHUNK // (a_bits * max(k, cols))))
    for r0 in range(0, m, rows):
        a = plane_bits(pa[:, r0:r0 + rows])
        a = a.reshape(-1, k)
        for c0 in range(0, n, cols):
            out[r0:r0 + rows, c0:c0 + cols] = count_pairs(
                a, pw[:, c0:c0 + cols], a_bits)
    return bitslice.to_int32_bits(out & 0xFFFFFFFF)


def bitserial_matmul_fused_plain(qa: torch.Tensor, pw: torch.Tensor,
                                 a_bits: int, w_bits: int) -> torch.Tensor:
    """Plain PyTorch version: slice and pack the codes, then Eq. 1."""
    kw = pw.shape[-1]
    qa = torch.nn.functional.pad(qa, (0, kw * 32 - qa.shape[1]))
    return packed_matmul_plain(bitslice.slice_and_pack(qa, a_bits),
                               pw[:w_bits])


def bitserial_matmul_fused_batched_plain(qa: torch.Tensor, pw: torch.Tensor,
                                         a_bits: int,
                                         w_bits: int) -> torch.Tensor:
    """Plain PyTorch version of the batched entry: the plain fused version
    on each expert's codes and planes."""
    return torch.stack([bitserial_matmul_fused_plain(q, p, a_bits, w_bits)
                        for q, p in zip(qa, pw)])


def bitserial_matmul_fused(qa: torch.Tensor, pw: torch.Tensor, a_bits: int,
                           w_bits: int, bm: int | None = None,
                           bkw: int | None = None) -> torch.Tensor:
    """qa (M, K) int32 codes, pw (w_bits, N, KW) int32 planes -> P (M, N)
    int32; ``bm``/``bkw`` are :func:`_plan`'s requests (the plain version
    has no plan)."""
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
    if m >= 2**31 or n >= 2**31 or kw * 32 >= 2**31:
        raise ValueError(f"({m}, {n}, {kw}) exceeds the kernel's int indices")
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=qa.device)
    out = _launch("fused", qa.contiguous(), pw.contiguous(), m, n, (k,), kw,
                  a_bits, w_bits, bm=bm, bkw=bkw)
    global launches
    launches += 1
    return out


def bitserial_matmul_fused_batched(qa: torch.Tensor, pw: torch.Tensor,
                                   a_bits: int, w_bits: int,
                                   bm: int | None = None,
                                   bkw: int | None = None) -> torch.Tensor:
    """E fused products in one launch: qa (E, M, K) int32 codes, pw (E,
    w_bits, N, KW) int32 planes -> P (E, M, N) int32; ``bm``/``bkw`` as
    :func:`bitserial_matmul_fused` takes them."""
    if qa.dim() != 3 or qa.dtype != torch.int32:
        raise ValueError(f"want (E, M, K) int32 codes, got {tuple(qa.shape)} "
                         f"{qa.dtype}")
    if (pw.dim() != 4 or pw.dtype != torch.int32 or pw.shape[1] != w_bits
            or pw.shape[0] != qa.shape[0]):
        raise ValueError(f"want ({qa.shape[0]}, {w_bits}, N, KW) int32 "
                         f"planes, got {tuple(pw.shape)} {pw.dtype}")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"<{w_bits}:{a_bits}>: the kernel takes 1..8 bits")
    e, m, k = qa.shape
    _, _, n, kw = pw.shape
    if k > kw * 32:
        raise ValueError(f"activation K={k} exceeds packed weight K={kw * 32}")
    if qa.device != pw.device:
        raise ValueError(f"operands on {qa.device} and {pw.device}")
    if qa.device.type == "cpu":
        return bitserial_matmul_fused_batched_plain(qa, pw, a_bits, w_bits)
    if qa.device.type != "cuda":
        raise ValueError(f"no bitserial_matmul for device {qa.device}")
    # Each index inside the kernel, and each product's offset, in range.
    if (e * m * max(n, k) >= 2**31 or e * w_bits * n * kw >= 2**31
            or kw * 32 >= 2**31 or e > 65535):
        raise ValueError(f"({e}, {m}, {n}, {kw}) exceeds the kernel's int "
                         "indices")
    if e == 0 or m == 0 or n == 0:
        return torch.empty((e, m, n), dtype=torch.int32, device=qa.device)
    out = _launch("fused_batched", qa.contiguous(), pw.contiguous(), m, n,
                  (k,), kw, a_bits, w_bits, e=e, bm=bm, bkw=bkw)
    global batched_launches
    batched_launches += 1
    return out


def bitserial_matmul_packed(pa: torch.Tensor, pw: torch.Tensor, a_bits: int,
                            w_bits: int, bm: int | None = None,
                            bkw: int | None = None) -> torch.Tensor:
    """pa (a_bits, M, KW), pw (w_bits, N, KW) int32 planes -> P (M, N)
    int32; ``bm``/``bkw`` as :func:`bitserial_matmul_fused` takes them."""
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
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=pa.device)
    out = _launch("packed", pa.contiguous(), pw.contiguous(), m, n, (), kw,
                  a_bits, w_bits, bm=bm, bkw=bkw)
    global packed_launches
    packed_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _entries() -> dict:
    """The C entry points by entry name, bound once, after holding the
    library's tiles equal to ``TILES`` and ``SLAB_WORDS``."""
    lib = _build.load("bitserial_matmul", _ARGTYPES)
    for variant, tile in enumerate(TILES):
        got = (ctypes.c_int * 4)()
        _build.check(lib, lib.repro_bitserial_matmul_tile(variant, got),
                     "bitserial_matmul_tile")
        if tuple(got) != (*tile, SLAB_WORDS):
            raise RuntimeError(f"bitserial_matmul.cu's tile {variant} is "
                               f"{tuple(got)}, _plan's "
                               f"{(*tile, SLAB_WORDS)}")
    return {e: getattr(lib, f"repro_bitserial_matmul_{e}")
            for e in ("fused", "packed", "fused_batched")}


def _launch(entry, a, pw, m, n, k, kw, a_bits, w_bits, e=None, bm=None,
            bkw=None) -> torch.Tensor:
    """One launch of ``repro_bitserial_matmul_<entry>`` with :func:`_plan`'s
    plan (at the ``bm``/``bkw`` requests, if any); ``k`` is ``(K,)`` for
    the fused entries, ``()`` for the packed; ``e`` is the batched entry's
    product count (its output (E, M, N)). On the split path the C entry
    zeroes ``out`` on the stream first."""
    plan = _plan(m, n, kw, _sm_count(a.device), 1 if e is None else e,
                 bm, bkw)
    lead = () if e is None else (e,)
    out = torch.empty((*lead, m, n), dtype=torch.int32, device=a.device)
    fn = _entries()[entry]
    args = (a.data_ptr(), pw.data_ptr(), out.data_ptr(), *lead, m, n, *k,
            kw, a_bits, w_bits, *plan)
    if a.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(a.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        _build.check(_build.load("bitserial_matmul", _ARGTYPES), rc,
                     f"bitserial_matmul_{entry}")
    return out
