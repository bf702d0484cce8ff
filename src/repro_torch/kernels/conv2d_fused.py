"""Fused implicit-im2col bit-serial convolution: the CUDA kernel's wrapper,
its launch plan and its plain PyTorch version.

Layouts (built by :func:`repro_torch.kernels.ops.conv2d_bitserial`):

  pa  (a_bits, N*Hp, Wp, CW) — activation codes packed along C (CW words),
      spatial padding applied beforehand with the ZERO code, which ANDs to
      a zero popcount, so patches match the materialized path bit-exactly.
  pw  (KH, w_bits, O, KW, CW) — ``PackedConvWeight.fused_planes``.
  out (N, OH, OW, O) int32 P.

Output row n*OH + oh reads input row n*Hp + oh*stride + kh for kernel row
kh, and output column ow reads word column kw + ow*stride: that index
arithmetic is the whole implicit im2col. A CUDA tensor launches
``csrc/conv2d_fused.cu`` (an implicit GEMM on the int8 tensor cores) with
the launch plan of :func:`_plan`; a CPU tensor runs
:func:`conv2d_fused_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import bitslice

from . import _build
from .bitserial_matmul import (_PLAIN_CHUNK, _sm_count, count_pairs,
                               plane_bits)

launches = 0

_ARGTYPES = {
    "repro_conv2d_fused": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 22
    + [ctypes.c_void_p],
    "repro_conv2d_fused_tile": [ctypes.POINTER(ctypes.c_int)],
    "repro_conv2d_fused_smem": [ctypes.c_int] * 9,
}

# The kernel's geometry (``repro_conv2d_fused_tile`` reports its own; the
# first launch holds them equal): output pixels and channels a block, the
# wide variant's ring stages and the narrow variant's most, the most words
# (32 K each) a block sums so that its s32 sum is exact (255^2 * 32,768 <
# 2^31), and the shared memory a block may take so that two blocks fit an
# SM (228 KB, 1 KB of it kept a block).
BM, BN, WIDE_STAGES, MAX_STAGES = 128, 64, 2, 3
SLAB_WORDS, SMEM_LIMIT = 1024, 112 * 1024
MAX_BITS = 8          # planes are staged for 8 bits at any precision
MAX_KS = 4            # wide variant: channel words a step
WIDE, NARROW = 0, 1   # variants: a channel word a K group; C bytes a pixel


class ConvPlan(NamedTuple):
    """How one conv is launched: the variant (``WIDE`` or ``NARROW``), the
    tile's ``tr`` output rows of ``tw`` columns (``tr * tw <= BM``), the
    channel words a step (``ks``, wide only), the contraction's pairs
    (wide: (kh, step); narrow: kh) cut into ``splits`` ranges of
    ``split_pairs``, each summed by its own blocks and added to the output
    with uint32 atomics when ``splits`` > 1, the ring's ``stages``, and the
    blocks along the output tiles (``m_blocks``: one a tile for the wide
    variant; the narrow variant's blocks each walk several tiles with their
    split's weights rebuilt once)."""
    variant: int
    tw: int
    tr: int
    ks: int
    split_pairs: int
    splits: int
    stages: int
    m_blocks: int


def _round4(words: int) -> int:
    return (words + 3) & ~3


def smem_bytes(variant: int, tw: int, tr: int, ks: int, split_pairs: int,
               stages: int, stride: int, kw: int, c: int) -> int:
    """Shared memory of a launch, as ``conv2d_fused.cu``'s ``layout``
    computes it. Wide: ``stages`` ring stages of activation and weight
    planes (8 planes each), then two buffers each of the staged pixels' u8
    codes and of the weight tile. Narrow: ``stages`` stages of activation
    planes, two buffers of the dense rows of codes, and the weights of
    ``split_pairs`` kernel rows."""
    span = (tw - 1) * stride + kw
    ncols = tr * span
    if variant == WIDE:
        pad = 1 if stride % 4 == 0 else 2 if stride % 2 == 0 else 4
        ring = _round4(MAX_BITS * ncols * ks) + _round4(MAX_BITS * BN * ks)
        tiles = 2 * (_round4(ncols * (8 * ks + pad))
                     + _round4(BN * (8 * ks + 4)))
    else:
        groups = -(-kw * c // 32)
        ring = _round4(MAX_BITS * ncols)
        tiles = (2 * _round4((tr * ((span * c + 15) & ~15) + 64) // 4)
                 + split_pairs * _round4(BN * (8 * groups + 4)))
    return 4 * (stages * ring + tiles)


@functools.lru_cache(maxsize=4096)
def _plan(n_oh: int, ow: int, cw: int, c: int, o: int, kh: int, kw: int,
          stride: int, sms: int) -> ConvPlan:
    """The launch plan of a conv on a card of ``sms`` SMs.

    The narrow variant exactly when C < 32. The tile: OW in equal parts of
    at most ``BM`` columns, and as many output rows as fill ``BM`` (fewer
    where shared memory would pass ``SMEM_LIMIT``); the wide variant's
    channel words in equal steps of at most 4. K is split where the tiles
    give fewer blocks than SMs, until the grid holds about two blocks an
    SM, and always into ranges of at most ``SLAB_WORDS`` words; the narrow
    variant also splits its kernel rows where their weights would not fit
    beside the tile. The narrow variant runs 3 ring stages where they fit,
    and about two blocks an SM, each walking an equal share of the tiles.
    """
    variant = NARROW if c < 32 else WIDE
    ks = 1 if variant == NARROW else -(-cw // -(-cw // MAX_KS))
    stages = WIDE_STAGES

    def fits(tw, tr, split_pairs, stages):
        return smem_bytes(variant, tw, tr, ks, split_pairs, stages, stride,
                          kw, c) <= SMEM_LIMIT

    pairs = kh * (1 if variant == NARROW else -(-cw // ks))
    per_pair = -(-kw * c // 32) if variant == NARROW else kw * ks
    most = SLAB_WORDS // per_pair
    if most < 1:
        raise ValueError(f"conv kernel {kh}x{kw}, C={c}: one kernel row "
                         f"passes {SLAB_WORDS} words")
    tw = ow if ow <= BM else -(-ow // -(-ow // BM))
    tr = max(1, min(BM // tw, n_oh))
    while not fits(tw, tr, 1, stages):
        if tr > 1:
            tr -= 1
        elif tw > 1:
            tw = -(-tw // 2)
        else:
            raise ValueError(f"conv kernel {kh}x{kw}, C={c}: no tile fits "
                             f"{SMEM_LIMIT} bytes of shared memory")
    while most > 1 and not fits(tw, tr, min(most, pairs), stages):
        most -= 1
    m_tiles = -(-n_oh // tr) * -(-ow // tw)
    tiles = m_tiles * -(-o // BN)
    splits = max(-(-2 * sms // tiles) if tiles < sms else 1,
                 -(-pairs // most))
    per = min(most, -(-pairs // min(splits, pairs, 65535)))
    splits = -(-pairs // per)
    m_blocks = m_tiles
    if variant == NARROW:
        if fits(tw, tr, per, MAX_STAGES):
            stages = MAX_STAGES
        m_blocks = -(-m_tiles // -(-tiles * splits // (2 * sms)))
    return ConvPlan(variant, tw, tr, ks, per, splits, stages, m_blocks)


def conv2d_fused_plain(pa: torch.Tensor, pw: torch.Tensor, *, n: int, hp: int,
                       oh: int, ow: int, stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version: gather each kernel row's (kw) taps of input
    words, AND them with the row's weight planes and popcount
    (``count_pairs``), summed in int64 and wrapped mod 2^32."""
    a_bits, _, _, cw = pa.shape
    kh_sz, _, o, kw_sz, _ = pw.shape
    k = kw_sz * cw * bitslice.LANE_BITS
    r = torch.arange(n * oh, device=pa.device)
    base = (r // oh) * hp + (r % oh) * stride
    out = torch.empty((n * oh, ow, o), dtype=torch.int64, device=pa.device)
    step = max(1, _PLAIN_CHUNK // (a_bits * ow * max(k, o)))
    for r0 in range(0, n * oh, step):
        rows = base[r0:r0 + step]
        acc = 0
        for kh in range(kh_sz):
            a_rows = pa[:, rows + kh]                     # (a_bits, R, Wp, CW)
            taps = torch.stack([a_rows[:, :, kw:kw + (ow - 1) * stride + 1:
                                       stride] for kw in range(kw_sz)], -2)
            a = plane_bits(taps).reshape(-1, k)           # (a_bits*R*OW, K)
            acc = acc + count_pairs(a, pw[kh], a_bits)    # (R*OW, O)
        out[r0:r0 + step] = acc.reshape(-1, ow, o)
    return bitslice.to_int32_bits(out & 0xFFFFFFFF).reshape(n, oh, ow, o)


def conv2d_bitserial_fused(pa: torch.Tensor, pw: torch.Tensor, *, n: int,
                           hp: int, oh: int, ow: int, stride: int = 1,
                           c: int | None = None) -> torch.Tensor:
    """Fused bit-serial conv -> P (N, OH, OW, O) int32.

    ``c`` is the number of channels the planes hold (lanes past it are
    zero in both operands). Below 32 the kernel packs the taps of a kernel
    row into its K groups. None, the default, keeps the reference's
    signature, which has no channel count: every lane of the CW words then
    counts and the wide variant runs, even below 32 channels (up to 10.7x
    the work at C = 3). :func:`repro_torch.kernels.ops.conv2d_bitserial`
    always passes ``c``.
    """
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
    c = 32 * cw if c is None else c
    if not 32 * (cw - 1) < c <= 32 * cw:
        raise ValueError(f"{c} channels in {cw} channel words")
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
    out = torch.empty((n, oh, ow, o), dtype=torch.int32, device=pa.device)
    if out.numel() == 0:
        return out
    pa, pw = pa.contiguous(), pw.contiguous()
    plan = _plan(n * oh, ow, cw, c, o, kh_sz, kw_sz, stride,
                 _sm_count(pa.device))
    lib = _library()
    _hold_smem(plan, stride, kw_sz, c)
    with torch.cuda.device(pa.device):
        rc = lib.repro_conv2d_fused(
            pa.data_ptr(), pw.data_ptr(), out.data_ptr(), n * oh, rows, hp,
            oh, ow, wp, cw, c, o, kh_sz, kw_sz, stride, a_bits, w_bits, *plan,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "conv2d_bitserial_fused")
    global launches
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library():
    """The C library, loaded once, after holding its geometry equal to this
    module's."""
    lib = _build.load("conv2d_fused", _ARGTYPES)
    got = (ctypes.c_int * 6)()
    _build.check(lib, lib.repro_conv2d_fused_tile(got), "conv2d_fused_tile")
    want = (BM, BN, WIDE_STAGES, MAX_STAGES, SLAB_WORDS, SMEM_LIMIT)
    if tuple(got) != want:
        raise RuntimeError(f"conv2d_fused.cu's geometry is {tuple(got)}, "
                           f"_plan's {want}")
    return lib


@functools.lru_cache(maxsize=4096)
def _hold_smem(plan: ConvPlan, stride: int, kw: int, c: int) -> None:
    """Holds :func:`smem_bytes` equal to the library's own count, once a
    plan: the C entry refuses a plan past ``SMEM_LIMIT`` by its count, so a
    drift between the two would refuse plans that ``_plan`` sized to fit."""
    geometry = (plan.variant, plan.tw, plan.tr, plan.ks, plan.split_pairs,
                plan.stages, stride, kw, c)
    got = _library().repro_conv2d_fused_smem(*geometry)
    if got != smem_bytes(*geometry):
        raise RuntimeError(f"conv2d_fused.cu counts {got} bytes of shared "
                           f"memory for {plan}, smem_bytes "
                           f"{smem_bytes(*geometry)}")
