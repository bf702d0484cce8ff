"""Prepacked weights — the paper's "program subarrays once" step.

On NAND-SPIN, weights are written into the subarrays exactly once at
deployment; every inference afterwards only streams activations. The
counterpart here is :class:`PackedWeight`: the weight's integer codes, its
packed bit-planes (the subarray image), the Eq. 2 quantization parameters
and the precomputed column sums of the affine correction.

``prepack`` builds it for a (K, N) matmul weight, or for an (E, K, N) MoE
expert bank (one PackedWeight with a leading expert axis on every leaf,
each expert calibrated on itself); ``prepack_conv`` for a
(KH, KW, C, O) convolution weight, which additionally carries the
channel-packed per-kernel-row planes consumed by the fused implicit-im2col
kernel (:mod:`repro_torch.kernels.conv2d_fused`). Planes are int32 bit
patterns (see :mod:`.bitslice`), packed by ``kernels.ops.pack_planes``: on
a CUDA tensor kernel 1, on a CPU tensor its plain version.

A :class:`TuneDecision` rides on each packed weight as ``tune`` (None
until the autotuner, :mod:`repro_torch.pim.autotune`, attaches one), and
every device move keeps it.

Codes of at most 8 bits are kept as ``uint8``, a quarter of the int32 the
JAX package keeps: the planes and column sums are computed from the int32
codes first, and every reader of ``codes`` widens them (``codes32``), so
no product or dequantized value moves. Wider codes stay int32.
"""
from __future__ import annotations

import dataclasses

import torch

from .quantize import QuantParams, calibrate_minmax, dequantize, quantize


def pack_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes (M, K) -> planes (bits, M, ceil(K/32)) (``ops.pack_planes``)."""
    from repro_torch.kernels import ops   # lazy: the kernels import core

    return ops.pack_planes(q, bits)


@dataclasses.dataclass(frozen=True)
class TuneDecision:
    """Autotuner verdict carried on a packed weight.

    ``backend`` overrides the config's Eq. 1 execution strategy at use
    time; ``bm``/``bn``/``bkw`` are tile *requests* for kernels 2 and 4
    (legalized against the operands by ``kernels.ops.matmul_tiles``, so a
    decision never makes an illegal launch plan); ``conv_mode``/``bo``
    steer ``pim_conv2d``'s lowering path and the fused conv's O block.
    ``None`` fields defer to the planner and heuristic defaults: a
    ``TuneDecision`` with only a backend changes dispatch and nothing else.
    Frozen and hashable; attaching one copies no tensor.
    """

    backend: str = "popcount"
    bm: int | None = None
    bn: int | None = None
    bkw: int | None = None
    conv_mode: str | None = None   # "fused" | "im2col" (conv weights only)
    bo: int | None = None          # fused-conv O block (conv weights only)


@dataclasses.dataclass(frozen=True)
class PackedWeight:
    """A (K, N) weight quantized and bit-plane-packed once.

    codes     (K, N) uint8 at <= 8 bits, int32 above
                                    — Eq. 2 codes (the multi-bit matrix);
                                      read them through ``codes32``
    planes    (bits, N, KW) int32   — K-packed planes of ``codes.T``
    col_sums  (N,) int32            — sum_k codes[k, n] (Sw of the algebra)
    wq        QuantParams           — scale/qmin/bits of the weight
    tune      TuneDecision | None   — the autotuner's verdict; None keeps
                                      the config's backend and the
                                      planner's tiles

    An (E, K, N) expert bank keeps the JAX package's ``vmap``-ed layout:
    codes (E, K, N), planes (E, bits, N, KW), col_sums (E, N) and a ``wq``
    whose scale and qmin are (E,).
    """

    codes: torch.Tensor
    planes: torch.Tensor
    col_sums: torch.Tensor
    wq: QuantParams
    tune: TuneDecision | None = None

    @property
    def bits(self) -> int:
        return self.wq.bits

    @property
    def shape(self) -> tuple:
        return tuple(self.codes.shape)

    @property
    def codes32(self) -> torch.Tensor:
        """The codes as int32, the JAX package's type (a new tensor when
        they are kept as bytes)."""
        return self.codes.to(torch.int32)

    @property
    def is_bank(self) -> bool:
        """An (E, K, N) expert bank (per-expert ``wq``)."""
        return self.codes.dim() == 3

    def to_float(self) -> torch.Tensor:
        """Dequantized master weight (``dequantize`` casts the codes to
        float32 itself); a bank dequantizes each expert with its own
        ``wq``."""
        wq = self.wq.per_expert() if self.is_bank else self.wq
        return dequantize(self.codes, wq)

    def to(self, device) -> PackedWeight:
        """The weight on ``device``; every other field (``tune``) kept."""
        return dataclasses.replace(
            self, codes=self.codes.to(device), planes=self.planes.to(device),
            col_sums=self.col_sums.to(device), wq=self.wq.to(device))


@dataclasses.dataclass(frozen=True)
class PackedConvWeight:
    """A (KH, KW, C, O) conv weight prepacked for both conv lowering paths.

    mat          PackedWeight over the (KH*KW*C, O) im2col matrix — drives
                 the materialized path and the affine correction.
    fused_planes (KH, bits, O, KW, CW) int32 — channel-packed planes per
                 kernel row, the layout the fused implicit-im2col kernel
                 reads one (kh) slab at a time.
    tune         TuneDecision | None — the conv-level verdict (route and O
                 block); the im2col product's rides on ``mat.tune``.
    """

    mat: PackedWeight
    fused_planes: torch.Tensor
    kernel_shape: tuple = (1, 1, 1, 1)
    tune: TuneDecision | None = None

    @property
    def bits(self) -> int:
        return self.mat.bits

    @property
    def wq(self) -> QuantParams:
        return self.mat.wq

    def to_float(self) -> torch.Tensor:
        return self.mat.to_float().reshape(self.kernel_shape)

    def to(self, device) -> PackedConvWeight:
        return dataclasses.replace(self, mat=self.mat.to(device),
                                   fused_planes=self.fused_planes.to(device))


def narrow_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 codes of ``bits`` bits as kept in a PackedWeight: uint8 at
    <= 8 bits (every code fits a byte), int32 above."""
    return codes.to(torch.uint8) if bits <= 8 else codes


def prepack(w: torch.Tensor, w_bits: int) -> PackedWeight:
    """Quantize + bit-slice + lane-pack a (K, N) weight, or an (E, K, N)
    expert bank, once."""
    if w.dim() == 3:
        return _prepack_bank(w, w_bits)
    wq = calibrate_minmax(w, w_bits)
    codes = quantize(w, wq)
    planes = pack_planes(codes.T.contiguous(), w_bits)
    # Summed in int32, as the JAX package sums (wrapping alike): an int64
    # sum would first copy the codes to int64.
    col_sums = codes.sum(0, dtype=torch.int32)
    return PackedWeight(codes=narrow_codes(codes, w_bits), planes=planes,
                        col_sums=col_sums, wq=wq)


def _prepack_bank(w: torch.Tensor, w_bits: int) -> PackedWeight:
    """An (E, K, N) bank: each expert calibrated on itself, and the whole
    bank's planes in one pack (:func:`_pack_bank_planes`)."""
    wq = calibrate_minmax(w, w_bits, per_expert=True)
    codes = quantize(w, wq.per_expert())                # (E, K, N)
    return PackedWeight(codes=narrow_codes(codes, w_bits),
                        planes=_pack_bank_planes(codes, w_bits),
                        col_sums=codes.sum(1, dtype=torch.int32), wq=wq)


def _pack_bank_planes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """The planes of (E, K, N) bank codes in one pack: the (E*N, K) rows
    of their transpose, then a permute to (E, bits, N, KW)."""
    e, k, n = codes.shape
    planes = pack_planes(codes.transpose(1, 2).reshape(e * n, k), bits)
    return planes.reshape(bits, e, n, -1).transpose(0, 1).contiguous()


def repack_codes(pw: PackedWeight, codes: torch.Tensor) -> PackedWeight:
    """Re-program a packed weight's subarrays with new integer codes.

    ``codes`` (K, N), or (E, K, N) for a bank, as ``uint8`` or int32.
    The planes are re-derived from them (one pack, a bank's in one pack as
    ``prepack`` packs it); the digital periphery state (``col_sums``,
    ``wq``) and ``tune`` are kept as they are. This is the primitive
    behind fault injection and spare-column repair
    (:mod:`repro_torch.pim.faults`): the array image changes, the
    periphery's golden Sw register does not.
    """
    bits = pw.bits
    codes32 = codes.to(torch.int32)
    planes = (_pack_bank_planes(codes32, bits) if codes.dim() == 3
              else pack_planes(codes32.T.contiguous(), bits))
    return dataclasses.replace(pw, codes=narrow_codes(codes32, bits),
                               planes=planes)


def pack_fused_planes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(KH, KW, C, O) codes -> the fused layout (KH, bits, O, KW, CW): per
    kernel row kh, O-major, channels packed into words (one pack)."""
    kh, kw, c, o = codes.shape
    wt = codes.permute(0, 3, 1, 2).contiguous()          # (KH, O, KW, C)
    fused = pack_planes(wt.reshape(kh * o * kw, c), bits).reshape(
        bits, kh, o, kw, -1)                             # (bits, KH, O, KW, CW)
    return fused.permute(1, 0, 2, 3, 4).contiguous()     # (KH, bits, O, KW, CW)


def repack_conv_codes(pcw: PackedConvWeight, flat_codes: torch.Tensor
                      ) -> PackedConvWeight:
    """Conv analog of :func:`repack_codes`: new (KH*KW*C, O) im2col codes,
    both lowering layouts (``mat`` and ``fused_planes``) rebuilt so they
    describe the same device state."""
    flat32 = flat_codes.to(torch.int32)
    return dataclasses.replace(
        pcw, mat=repack_codes(pcw.mat, flat32),
        fused_planes=pack_fused_planes(flat32.reshape(pcw.kernel_shape),
                                   pcw.bits))


def prepack_conv(w: torch.Tensor, w_bits: int) -> PackedConvWeight:
    """Prepack a (KH, KW, C, O) conv weight for both lowering paths."""
    kh, kw, c, o = w.shape
    wq = calibrate_minmax(w, w_bits)
    codes = quantize(w, wq)                              # (KH, KW, C, O)
    flat = codes.reshape(kh * kw * c, o)                 # im2col order
    mat = PackedWeight(
        codes=narrow_codes(flat, w_bits),
        planes=pack_planes(flat.T.contiguous(), w_bits),
        col_sums=flat.sum(0, dtype=torch.int32),
        wq=wq,
    )
    return PackedConvWeight(mat=mat, fused_planes=pack_fused_planes(codes, w_bits),
                            kernel_shape=(kh, kw, c, o))
