"""AlexNet (paper benchmark #1)."""
from __future__ import annotations

import torch

from . import layers as L
from .specs import affine_spec, conv_spec, fc_spec, pool_spec

# (name, cout, k, stride, pad, pool_after(k, s) or None)
_CONVS = [
    ("conv1", 96, 11, 4, 2, (3, 2)),
    ("conv2", 256, 5, 1, 2, (3, 2)),
    ("conv3", 384, 3, 1, 1, None),
    ("conv4", 384, 3, 1, 1, None),
    ("conv5", 256, 3, 1, 1, (3, 2)),
]
_FCS = [4096, 4096]


def _feature_hw(image: int) -> int:
    h = image
    for _, _, k, s, p, pool in _CONVS:
        h = (h + 2 * p - k) // s + 1
        if pool:
            h = (h - pool[0]) // pool[1] + 1
    return h


def init(gen: torch.Generator, num_classes=1000, image=224):
    """Random float parameters from ``gen`` (on the CPU)."""
    params = {}
    cin = 3
    for name, cout, k, *_rest in _CONVS:
        params[name] = L.init_conv(gen, k, cin, cout)
        cin = cout
    h = _feature_hw(image)
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
    for name, _, _, s, p, pool in _CONVS:
        x = L.conv_block(params[name], x, stride=s, padding=p, cfg=cfg,
                         train=train)
        if pool:
            x = L.max_pool(x, *pool)
    x = x.reshape(x.shape[0], -1)
    for j in range(len(_FCS)):
        x = L.fc_block(params[f"fc{j + 1}"], x, cfg=cfg, train=train)
    return L.fc_block(params["head"], x, cfg=cfg, relu=False, train=train)


def layer_specs(batch=1, image=224, num_classes=1000):
    specs = []
    h = image
    cin = 3
    for name, cout, k, s, p, pool in _CONVS:
        spec, h, _ = conv_spec(name, batch, h, h, cin, cout, k, s, p)
        specs += [spec,
                  affine_spec(f"{name}.bn", "bn", spec.out_elems),
                  affine_spec(f"{name}.q", "quant", spec.out_elems)]
        if pool:
            pspec, h, _ = pool_spec(f"{name}.pool", batch, h, h, cout, *pool)
            specs.append(pspec)
        cin = cout
    dim = h * h * cin
    for j, width in enumerate(_FCS + [num_classes]):
        nm = f"fc{j + 1}" if j < len(_FCS) else "head"
        specs += [fc_spec(nm, batch, dim, width),
                  affine_spec(f"{nm}.q", "quant", batch * width)]
        dim = width
    return specs
