"""PIM-style quantized layers — the paper's technique as drop-in functions.

``pim_linear``/``pim_conv2d`` run a dense projection or an NHWC convolution
either in float (``cfg`` None or disabled) or through the paper's
bit-serial pipeline: Eq. 2 calibration and quantization of the activation,
the Eq. 1 integer product on the configured backend ("popcount" |
"mxu-plane" | "int-direct" | "cuda", see :mod:`.bitserial`), and the affine
correction back to floats.

Weights may be float master arrays (quantized per call) or prepacked
:class:`PackedWeight`/:class:`PackedConvWeight` built once by
:func:`prepack_linear`/:func:`prepack_conv2d`.

Conv2D lowers to the integer product two ways: a materialized im2col patch
matrix (cheap for 1x1 kernels and small maps), or the fused
implicit-im2col kernel that never builds the (N*OH*OW, KH*KW*C) matrix.
:func:`fuse_conv_heuristic` picks one (the fused kernel only for the
``"cuda"`` backend), or ``conv_mode`` forces it.

``train=True`` is quantization-aware training: fake quantization with a
straight-through estimator (:func:`.quantize.fake_quant`) and float
products, as in the JAX package.

Layouts are the JAX package's: NHWC activations, HWIO conv weights. Float
convolutions and the border correction's mask conv must not run in TF32
(see :func:`repro_torch.disable_tf32`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .bitserial import BACKENDS, int_matmul_prepacked, quantized_matmul
from .packed import PackedConvWeight, PackedWeight, prepack, prepack_conv
from .quantize import affine_correction, calibrate_minmax, fake_quant, quantize


@dataclasses.dataclass(frozen=True)
class PIMQuantConfig:
    w_bits: int = 8
    a_bits: int = 8
    backend: str = "cuda"   # the kernels (JAX's "pallas"); see BACKENDS
    enabled: bool = True

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(ported: {BACKENDS})")

    @property
    def tag(self) -> str:
        return f"<{self.w_bits}:{self.a_bits}>"


def prepack_linear(w: torch.Tensor, cfg: PIMQuantConfig) -> PackedWeight:
    """Quantize + pack a (K, N) weight once for repeated ``pim_linear`` calls."""
    return prepack(w, cfg.w_bits)


def prepack_conv2d(w: torch.Tensor, cfg: PIMQuantConfig) -> PackedConvWeight:
    """Quantize + pack a (KH, KW, C, O) conv weight once for ``pim_conv2d``."""
    return prepack_conv(w, cfg.w_bits)


def pim_linear(x: torch.Tensor, w, b: torch.Tensor | None = None,
               cfg: PIMQuantConfig | None = None,
               train: bool = False) -> torch.Tensor:
    """y = x @ w (+ b) through the paper's bit-serial pipeline.

    ``x`` (..., K) float; ``w`` a (K, N) float weight or a
    :class:`PackedWeight`. Leading dimensions of ``x`` are flattened for the
    product (one calibration over all of them) and restored.

    ``train``: quantization-aware training. The activation and the float
    weight (a packed weight's ``to_float()``: prepacking is an inference
    artifact) are fake-quantized with straight-through gradients and
    multiplied in float, as the JAX package does; no bit-serial kernel
    runs.
    """
    packed = isinstance(w, PackedWeight)
    if cfg is None or not cfg.enabled:
        wf = w.to_float() if packed else w
        y = x @ wf.to(x.dtype)
    elif train:
        xq = fake_quant(x, cfg.a_bits)
        wq = fake_quant(w.to_float() if packed else w, cfg.w_bits)
        y = xq @ wq.to(xq.dtype)
    else:
        y = quantized_matmul(x, w, a_bits=cfg.a_bits, w_bits=cfg.w_bits,
                             backend=cfg.backend).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """NHWC -> (N*OH*OW, KH*KW*C) patches (float x or integer codes)."""
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, padding, padding, padding, padding))
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    # (n, oh, ow, c, kh, kw) -> (n, oh, ow, kh, kw, c)
    patches = x.unfold(1, kh, stride).unfold(2, kw, stride)
    patches = patches.permute(0, 1, 2, 4, 5, 3)
    return patches.reshape(n * oh * ow, kh * kw * c), oh, ow


# Fused-conv dispatch: below this patch-matrix size the materialized path's
# single big product beats the fused kernel's per-row streaming.
_FUSE_MIN_BYTES = 4 << 20


def fuse_conv_heuristic(n: int, oh: int, ow: int, kh: int, kw: int, c: int,
                        backend: str) -> bool:
    """Should ``pim_conv2d`` take the fused implicit-im2col path?

    Fires for the kernel backend, for kernels larger than 1x1, where the
    materialized (N*OH*OW, KH*KW*C) patch matrix would be at least
    ``_FUSE_MIN_BYTES`` — where the JAX package fires for ``"pallas"``.
    """
    if backend != "cuda":
        return False
    if kh == kw == 1:
        return False
    return 4 * n * oh * ow * kh * kw * c >= _FUSE_MIN_BYTES


def _box_sum(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """VALID strided (kh, kw) window sums over dims 1, 2 of (N, H, W)."""
    return x.unfold(1, kh, stride).unfold(2, kw, stride).sum((-2, -1))


def _nchw_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    """NHWC x HWIO float convolution -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def pim_conv2d(x: torch.Tensor, w, b: torch.Tensor | None = None,
               stride: int = 1, padding: int = 0,
               cfg: PIMQuantConfig | None = None, train: bool = False,
               conv_mode: str = "auto") -> torch.Tensor:
    """NHWC convolution with an HWIO weight (float or prepacked).

    ``train``: quantization-aware training, the float patch matrix
    (im2col) through ``pim_linear(train=True)``."""
    packed = isinstance(w, PackedConvWeight)
    kh, kw, c, o = w.kernel_shape if packed else w.shape
    if cfg is None or not cfg.enabled:
        wf = w.to_float() if packed else w
        y = _nchw_conv(x, wf.to(x.dtype), stride, padding)
        return y + b.to(y.dtype) if b is not None else y
    if train:
        wf = w.to_float() if packed else w
        cols, oh, ow = _im2col(x, kh, kw, stride, padding)
        y = pim_linear(cols, wf.reshape(kh * kw * c, o), b, cfg, train=True)
        return y.reshape(x.shape[0], oh, ow, o)
    if conv_mode not in ("auto", "fused", "im2col"):
        raise ValueError(f"conv_mode {conv_mode!r}: want auto|fused|im2col")

    n = x.shape[0]
    # Calibrate on the REAL activations, then pad with the zero CODE (never
    # the float input): padding contributes nothing to P or Sa, and the
    # affine correction below charges padded taps exactly zero.
    aq = calibrate_minmax(x, cfg.a_bits)
    qx = F.pad(quantize(x, aq), (0, 0, padding, padding, padding, padding))
    hp, wp = qx.shape[1], qx.shape[2]
    oh = (hp - kh) // stride + 1
    ow = (wp - kw) // stride + 1
    if not packed:
        w = prepack_conv(w, cfg.w_bits)

    # A conv-level TuneDecision (repro_torch.pim.autotune) resolves "auto"
    # and supplies the fused O block; an explicit conv_mode still wins, and
    # the im2col product's backend rides on w.mat.tune inside
    # int_matmul_prepacked. Tuning moves dispatch, never bits.
    tune = w.tune
    if conv_mode == "auto" and tune is not None and tune.conv_mode:
        conv_mode = tune.conv_mode
    fused = {"fused": True, "im2col": False}.get(
        conv_mode, fuse_conv_heuristic(n, oh, ow, kh, kw, c, cfg.backend))
    if fused:
        from repro_torch.kernels import ops as _kops

        p = _kops.conv2d_bitserial(qx, w.fused_planes, a_bits=cfg.a_bits,
                                   stride=stride,
                                   bo=tune.bo if tune is not None else None)
    else:
        qcols, _, _ = _im2col(qx, kh, kw, stride, 0)
        p = int_matmul_prepacked(qcols, w.mat, cfg.a_bits, cfg.backend)
        p = p.reshape(n, oh, ow, o)
    # Patch-wise activation code sums for the correction: an exact integer
    # box sum over the per-pixel channel sums — no patch matrix needed.
    sa = _box_sum(qx.sum(-1), kh, kw, stride)
    if padding:
        # Padded taps contribute exactly zero, so near the border the
        # correction's weight-code sum Sw and contraction length K shrink
        # per patch: a float32 conv of the validity mask against per-tap
        # channel-summed weight codes (integers below 2^24, so exact unless
        # it runs in TF32), and a box count of the mask.
        mask = F.pad(torch.ones((1, x.shape[1], x.shape[2], 1),
                                dtype=torch.float32, device=x.device),
                     (0, 0, padding, padding, padding, padding))
        wsum = w.mat.codes32.reshape(kh, kw, c, o).sum(2)        # (KH, KW, O)
        sw = _nchw_conv(mask, wsum[:, :, None, :].to(torch.float32),
                        stride, 0)                               # (1,OH,OW,O)
        k_real = c * _box_sum(mask[..., 0], kh, kw, stride)[..., None]
    else:
        sw, k_real = w.mat.col_sums, kh * kw * c
    y = affine_correction(p, sa[..., None], sw, k_real, aq,
                          w.wq).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
