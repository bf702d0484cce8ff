"""Layer-spec tables for the PIM architecture simulator.

Every compute layer is reduced to the GEMM the paper's subarrays execute
(convolution via the Fig. 8 sliding-window schedule == im2col):

    M = batch * OH * OW       output positions
    K = KH * KW * C_in        contraction length
    N = C_out                 output channels (bit-counter columns)

Pool/BN/quant layers carry element counts — the simulator charges their
in-memory addition / comparison / affine costs (paper §4.1-4.2).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    name: str
    kind: str            # conv | fc | pool_max | pool_avg | bn | quant | act
    m: int = 0           # GEMM rows (output positions)
    k: int = 0           # contraction length
    n: int = 0           # output channels
    out_elems: int = 0   # activation elements produced
    in_elems: int = 0    # activation elements consumed
    weight_elems: int = 0
    window: int = 0      # pooling window size (elements compared/summed)

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


def conv_spec(name, batch, h, w, cin, cout, k, s, p) -> tuple[GemmSpec, int, int]:
    oh = (h + 2 * p - k) // s + 1
    ow = (w + 2 * p - k) // s + 1
    spec = GemmSpec(
        name=name, kind="conv", m=batch * oh * ow, k=k * k * cin, n=cout,
        out_elems=batch * oh * ow * cout, in_elems=batch * h * w * cin,
        weight_elems=k * k * cin * cout,
    )
    return spec, oh, ow


def pool_spec(name, batch, h, w, c, k, s, kind="pool_max") -> tuple[GemmSpec, int, int]:
    oh = (h - k) // s + 1
    ow = (w - k) // s + 1
    spec = GemmSpec(
        name=name, kind=kind, out_elems=batch * oh * ow * c,
        in_elems=batch * h * w * c, window=k * k,
    )
    return spec, oh, ow


def fc_spec(name, batch, cin, cout) -> GemmSpec:
    # The paper folds FC into 1x1 convolution (§4.2); same GEMM form.
    return GemmSpec(
        name=name, kind="fc", m=batch, k=cin, n=cout,
        out_elems=batch * cout, in_elems=batch * cin, weight_elems=cin * cout,
    )


def affine_spec(name, kind, elems) -> GemmSpec:
    return GemmSpec(name=name, kind=kind, out_elems=elems, in_elems=elems)


def model_specs(model: str, batch: int = 1, image: int = 224) -> list[GemmSpec]:
    from . import alexnet, resnet, vgg

    return {
        "alexnet": alexnet.layer_specs,
        "vgg19": vgg.layer_specs,
        "resnet50": resnet.layer_specs,
    }[model](batch=batch, image=image)


def total_macs(specs: list[GemmSpec]) -> int:
    return sum(s.macs for s in specs)
