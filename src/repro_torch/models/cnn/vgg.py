"""VGG19 (paper benchmark #2)."""
from __future__ import annotations

import torch

from . import layers as L
from .specs import affine_spec, conv_spec, fc_spec, pool_spec

# VGG19: stage widths x conv counts, maxpool 2x2/2 after each stage.
_STAGES = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
_FCS = [4096, 4096]


def init(gen: torch.Generator, num_classes=1000, image=224):
    """Random float parameters from ``gen`` (on the CPU)."""
    params = {}
    cin = 3
    for s, (cout, reps) in enumerate(_STAGES):
        for i in range(reps):
            params[f"conv{s + 1}_{i + 1}"] = L.init_conv(gen, 3, cin, cout)
            cin = cout
    h = image // 2 ** len(_STAGES)
    dim = h * h * cin
    for j, width in enumerate(_FCS):
        params[f"fc{j + 1}"] = L.init_fc(gen, dim, width)
        dim = width
    params["head"] = L.init_fc(gen, dim, num_classes)
    return params


def prepack(params, cfg):
    """Deployment: quantize+pack every weight once (program subarrays once)."""
    return L.prepack_params(params, cfg)


def apply(params, x, cfg=None, train=False):
    """NHWC images (N, H, W, 3) -> logits (N, num_classes)."""
    for s, (_cout, reps) in enumerate(_STAGES):
        for i in range(reps):
            x = L.conv_block(params[f"conv{s + 1}_{i + 1}"], x, stride=1,
                             padding=1, cfg=cfg, train=train)
        x = L.max_pool(x, 2, 2)
    x = x.reshape(x.shape[0], -1)
    for j in range(len(_FCS)):
        x = L.fc_block(params[f"fc{j + 1}"], x, cfg=cfg, train=train)
    return L.fc_block(params["head"], x, cfg=cfg, relu=False, train=train)


def layer_specs(batch=1, image=224, num_classes=1000):
    specs = []
    h, cin = image, 3
    for s, (cout, reps) in enumerate(_STAGES):
        for i in range(reps):
            name = f"conv{s + 1}_{i + 1}"
            spec, h, _ = conv_spec(name, batch, h, h, cin, cout, 3, 1, 1)
            specs += [spec,
                      affine_spec(f"{name}.bn", "bn", spec.out_elems),
                      affine_spec(f"{name}.q", "quant", spec.out_elems)]
            cin = cout
        pspec, h, _ = pool_spec(f"pool{s + 1}", batch, h, h, cout, 2, 2)
        specs.append(pspec)
    dim = h * h * cin
    for j, width in enumerate(_FCS + [num_classes]):
        nm = f"fc{j + 1}" if j < len(_FCS) else "head"
        specs += [fc_spec(nm, batch, dim, width),
                  affine_spec(f"{nm}.q", "quant", batch * width)]
        dim = width
    return specs
