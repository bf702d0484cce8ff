"""CNN building blocks on top of the PIM layers (paper §4.2 pipeline).

Each block mirrors the paper's per-layer schedule: bit-serial convolution ->
BN affine (Eq. 3 folded) -> ReLU -> re-quantization at the next layer.
Activations are NHWC and conv weights HWIO, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import (PIMQuantConfig, fold_batchnorm, pim_conv2d,
                              pim_linear, prepack_conv2d, prepack_linear)


def prepack_params(params, cfg: PIMQuantConfig | None, faults=None):
    """Quantize + pack every conv/fc weight in a CNN param tree exactly once.

    Replaces each ``"w"`` leaf with a :class:`PackedWeight` or
    :class:`PackedConvWeight`; biases and BN params pass through.

    ``faults``: an optional :class:`repro_torch.pim.faults.FaultConfig`:
    corrupt the freshly programmed planes with persistent device faults
    (and, with ``faults.checksum``, repair flagged columns from spares)
    before the tree ships, as a NAND-SPIN programming pass would.
    """
    if cfg is None or not cfg.enabled:
        return params

    def walk(p):
        if isinstance(p, dict):
            return {k: ((prepack_conv2d(v, cfg) if v.dim() == 4
                         else prepack_linear(v, cfg))
                        if k == "w" and isinstance(v, torch.Tensor)
                        else walk(v))
                    for k, v in p.items()}
        return p

    packed = walk(params)
    if faults is not None:
        from repro_torch.pim.faults import inject_tree

        packed, _ = inject_tree(packed, faults)
    return packed


def tree_to(params, device):
    """Move every tensor (and packed weight) of a param tree to ``device``."""
    if isinstance(params, dict):
        return {k: tree_to(v, device) for k, v in params.items()}
    return params.to(device)


def init_conv(gen: torch.Generator, k, cin, cout, bn=True):
    fan_in = k * k * cin
    p = {"w": torch.randn((k, k, cin, cout), generator=gen)
         * (2.0 / fan_in) ** 0.5}
    if bn:
        p.update(gamma=torch.ones(cout), beta=torch.zeros(cout),
                 mean=torch.zeros(cout), var=torch.ones(cout))
    else:
        p["b"] = torch.zeros(cout)
    return p


def init_fc(gen: torch.Generator, cin, cout):
    return {"w": torch.randn((cin, cout), generator=gen) * (2.0 / cin) ** 0.5,
            "b": torch.zeros(cout)}


def conv_block(p, x, stride=1, padding=0, cfg: PIMQuantConfig | None = None,
               relu=True, train=False):
    y = pim_conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding,
                   cfg=cfg, train=train)
    if "gamma" in p:
        scale, bias = fold_batchnorm(p["gamma"], p["beta"], p["mean"], p["var"])
        y = y * scale + bias
    return torch.relu(y) if relu else y


def fc_block(p, x, cfg: PIMQuantConfig | None = None, relu=True,
             train=False):
    y = pim_linear(x, p["w"], p["b"], cfg=cfg, train=train)
    return torch.relu(y) if relu else y


def max_pool(x, k, s):
    """NHWC max pool with no padding (the reference's VALID window)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def avg_pool_global(x):
    return x.mean(dim=(1, 2))
