"""The paper's own benchmark models (AlexNet / VGG19 / ResNet50, §5.3).

These run two ways:
  * through the port's CNN stack (:mod:`repro_torch.models.cnn`) with
    PIM-quantized layers — the numerical reproduction;
  * through the PIM architecture simulator (:mod:`repro_torch.pim`) — the
    performance/energy reproduction (Figs. 13-17, Table 3).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.pim_layers import PIMQuantConfig


@dataclasses.dataclass(frozen=True)
class CNNBenchConfig:
    name: str
    image: int = 224
    classes: int = 1000
    pim: PIMQuantConfig = PIMQuantConfig(w_bits=8, a_bits=8, backend="cuda")


CONFIGS = {
    "alexnet": CNNBenchConfig("alexnet"),
    "vgg19": CNNBenchConfig("vgg19"),
    "resnet50": CNNBenchConfig("resnet50"),
}

# The paper's precision sweep (Figs. 14-15). The kernels and the popcount
# backend take at most 8 bits; <16:16> runs on int-direct and mxu-plane and
# in the simulator.
WI_SWEEP = [(2, 2), (4, 4), (8, 8), (16, 16)]
