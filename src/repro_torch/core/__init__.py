"""Core of the port: the paper's bit-serial PIM arithmetic in PyTorch.

  quantize    — Eq. 2 affine quantization, Eq. 3 BN folding, fake_quant
  bitslice    — bit-plane decomposition + 32-lane packing (int32 words)
  packed      — weights quantized and packed once (PackedWeight)
  bitserial   — Eq. 1 product on four backends + affine correction
  pim_layers  — pim_linear / pim_conv2d + PIMQuantConfig
  mapping     — the paper's data-mapping scheme as subarray plans
"""
from .bitserial import BACKENDS, int_matmul, int_matmul_prepacked, quantized_matmul
from .bitslice import bitplanes, pack_bits, popcount, slice_and_pack, unpack_bits
from .mapping import SubarrayPlan, plan_subarrays
from .packed import PackedConvWeight, PackedWeight, prepack, prepack_conv
from .pim_layers import (PIMQuantConfig, fuse_conv_heuristic, pim_conv2d,
                         pim_linear, prepack_conv2d, prepack_linear)
from .quantize import (QuantParams, affine_correction, calibrate_minmax,
                       dequantize, fake_quant, fold_batchnorm, quantize)

__all__ = [
    "QuantParams", "affine_correction", "calibrate_minmax", "dequantize",
    "fake_quant", "fold_batchnorm", "quantize",
    "bitplanes", "pack_bits", "popcount", "slice_and_pack", "unpack_bits",
    "BACKENDS", "int_matmul", "int_matmul_prepacked", "quantized_matmul",
    "PackedConvWeight", "PackedWeight", "prepack", "prepack_conv",
    "PIMQuantConfig", "fuse_conv_heuristic", "pim_conv2d", "pim_linear",
    "prepack_conv2d", "prepack_linear",
    "SubarrayPlan", "plan_subarrays",
]
