"""ResNet-50 (paper benchmark #3 and its breakdown model, Fig. 16)."""
from __future__ import annotations

import torch

from . import layers as L
from .specs import affine_spec, conv_spec, fc_spec, pool_spec

# (blocks, mid_channels) per stage; out = 4 * mid. Read at call time.
_STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]


def init(gen: torch.Generator, num_classes=1000, image=224):
    """Random float parameters from ``gen`` (on the CPU)."""
    params = {"stem": L.init_conv(gen, 7, 3, 64)}
    cin = 64
    for s, (blocks, mid) in enumerate(_STAGES):
        cout = mid * 4
        for b in range(blocks):
            blk = {
                "c1": L.init_conv(gen, 1, cin, mid),
                "c2": L.init_conv(gen, 3, mid, mid),
                "c3": L.init_conv(gen, 1, mid, cout),
            }
            if b == 0:
                blk["proj"] = L.init_conv(gen, 1, cin, cout)
            params[f"s{s}b{b}"] = blk
            cin = cout
    params["head"] = L.init_fc(gen, cin, num_classes)
    return params


def prepack(params, cfg):
    """Deployment: quantize+pack every weight once (program subarrays once)."""
    return L.prepack_params(params, cfg)


def _bottleneck(p, x, stride, cfg, train=False):
    y = L.conv_block(p["c1"], x, 1, 0, cfg=cfg, train=train)
    y = L.conv_block(p["c2"], y, stride, 1, cfg=cfg, train=train)
    y = L.conv_block(p["c3"], y, 1, 0, cfg=cfg, relu=False, train=train)
    if "proj" in p:
        x = L.conv_block(p["proj"], x, stride, 0, cfg=cfg, relu=False,
                         train=train)
    return torch.relu(x + y)


def apply(params, x, cfg=None, train=False):
    """NHWC images (N, H, W, 3) -> logits (N, num_classes)."""
    x = L.conv_block(params["stem"], x, stride=2, padding=3, cfg=cfg,
                     train=train)
    # The reference's stem pool is VALID (no padding), unlike torchvision's.
    x = L.max_pool(x, 3, 2)
    for s, (blocks, _mid) in enumerate(_STAGES):
        for b in range(blocks):
            x = _bottleneck(params[f"s{s}b{b}"], x,
                            2 if (b == 0 and s > 0) else 1, cfg, train)
    x = L.avg_pool_global(x)
    return L.fc_block(params["head"], x, cfg=cfg, relu=False, train=train)


def layer_specs(batch=1, image=224, num_classes=1000):
    specs = []
    spec, h, _ = conv_spec("stem", batch, image, image, 3, 64, 7, 2, 3)
    specs += [spec, affine_spec("stem.bn", "bn", spec.out_elems),
              affine_spec("stem.q", "quant", spec.out_elems)]
    pspec, h, _ = pool_spec("stem.pool", batch, h + 1, h + 1, 64, 3, 2)
    specs.append(pspec)
    cin = 64
    for s, (blocks, mid) in enumerate(_STAGES):
        cout = mid * 4
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            pre = f"s{s}b{b}"
            c1, h1, _ = conv_spec(f"{pre}.c1", batch, h, h, cin, mid, 1, 1, 0)
            c2, h2, _ = conv_spec(f"{pre}.c2", batch, h1, h1, mid, mid, 3,
                                  stride, 1)
            c3, h3, _ = conv_spec(f"{pre}.c3", batch, h2, h2, mid, cout, 1, 1,
                                  0)
            for c in (c1, c2, c3):
                specs += [c, affine_spec(f"{c.name}.bn", "bn", c.out_elems),
                          affine_spec(f"{c.name}.q", "quant", c.out_elems)]
            if b == 0:
                pj, _, _ = conv_spec(f"{pre}.proj", batch, h, h, cin, cout, 1,
                                     stride, 0)
                specs += [pj, affine_spec(f"{pre}.proj.bn", "bn", pj.out_elems)]
            h = h3
            cin = cout
    specs.append(affine_spec("gap", "pool_avg", batch * cin))
    specs += [fc_spec("head", batch, cin, num_classes),
              affine_spec("head.q", "quant", batch * num_classes)]
    return specs
