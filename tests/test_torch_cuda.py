"""The port's CUDA kernels on the card: each wrapper against its plain
version on the same CUDA tensors, the launch counters, and the rule that a
CUDA tensor never reaches a library kernel for the Eq. 1 product or the
fused conv. Marked ``cuda``: without a GPU every test here skips. This file
imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import pim_layers as tpl
from repro_torch.core.packed import prepack, prepack_conv
from repro_torch.kernels import bitplane_pack as kp
from repro_torch.kernels import bitserial_matmul as km
from repro_torch.kernels import conv2d_fused as kc
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (sm_90a)")
    return torch.Generator(device="cuda").manual_seed(0)


def _codes(gen, shape, bits):
    return torch.randint(0, 2**bits, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


@pytest.mark.parametrize("m,k,bits", [(37, 70, 2), (300, 3, 8), (64, 256, 4)])
def test_pack_kernel_equals_plain(gen, m, k, bits):
    q = _codes(gen, (m, k), bits)
    assert torch.equal(kp.bitplane_pack(q, bits), kp.bitplane_pack_plain(q, bits))


@pytest.mark.parametrize("m,k,n", [(37, 70, 131), (8, 2048, 1000),
                                   (130, 576, 64)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_matmul_kernel_equals_plain(gen, m, k, n, bits):
    qa = _codes(gen, (m, k), bits)
    pw = prepack(torch.randn((k, n), generator=gen, device="cuda"), bits)
    assert torch.equal(km.bitserial_matmul_fused(qa, pw.planes, bits, bits),
                       km.bitserial_matmul_fused_plain(qa, pw.planes, bits,
                                                       bits))


@pytest.mark.parametrize("m,kw,n", [
    (8, 2, 192), (8, 2, 320),     # the Pallas bn % 128 != 0 regression shapes
    (8, 288, 4096),               # AlexNet fc1, a bucket of 8
    (8, 128, 1000),               # AlexNet head
    (37, 13, 131),                # M, KW and N all ragged against the tile
    (5832, 75, 256)])             # AlexNet conv2 im2col, a bucket of 8
@pytest.mark.parametrize("ab,wb", [(2, 2), (4, 4), (8, 8), (3, 5)])
def test_packed_matmul_kernel_equals_plain(gen, m, kw, n, ab, wb):
    """Kernel 4 on random full words (bit 31 set), so every lane counts."""
    def words(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen,
                             device="cuda", dtype=torch.int64).to(torch.int32)
    pa, pw = words((ab, m, kw)), words((wb, n, kw))
    assert torch.equal(km.bitserial_matmul_packed(pa, pw, ab, wb),
                       km.packed_matmul_plain(pa, pw))


@pytest.mark.parametrize("shape,o,ks,stride,pad", [
    ((2, 9, 13, 5), 131, 3, 2, 1), ((1, 20, 20, 3), 64, 7, 2, 3),
    ((2, 8, 8, 128), 128, 3, 1, 1), ((1, 5, 5, 600), 70, 3, 1, 0),
    ((1, 64, 64, 3), 96, 11, 4, 2),        # AlexNet conv1 11x11/4
    ((2, 7, 7, 96), 256, 5, 1, 2)])        # AlexNet conv2 5x5
@pytest.mark.parametrize("bits", [2, 8])
def test_conv_kernel_equals_plain(gen, shape, o, ks, stride, pad, bits):
    qx = F.pad(_codes(gen, shape, bits), (0, 0, pad, pad, pad, pad))
    n, hp, wp, c = qx.shape
    pw = prepack_conv(torch.randn((ks, ks, c, o), generator=gen,
                                  device="cuda"), bits).fused_planes
    pa = kp.bitplane_pack_plain(qx.reshape(n * hp * wp, c), bits).reshape(
        bits, n * hp, wp, -1)
    geo = dict(n=n, hp=hp, oh=(hp - ks) // stride + 1,
               ow=(wp - ks) // stride + 1, stride=stride)
    assert torch.equal(kc.conv2d_bitserial_fused(pa, pw, **geo),
                       kc.conv2d_fused_plain(pa, pw, **geo))


def test_cuda_layers_launch_kernels_and_no_library_product(gen, monkeypatch):
    """The quantized layers on CUDA tensors count one launch per kernel
    call and compute P without torch.matmul, F.conv2d or torch._int_mm."""
    x = torch.randn((2, 12, 12, 64), generator=gen, device="cuda")
    w = prepack_conv(torch.randn((3, 3, 64, 32), generator=gen,
                                 device="cuda"), 8)
    fc = prepack(torch.randn((64, 10), generator=gen, device="cuda"), 8)
    cfg = tpl.PIMQuantConfig(8, 8, backend="cuda")
    want_conv = tpl.pim_conv2d(x.cpu(), w.to("cpu"), cfg=cfg,
                               conv_mode="fused")
    want_fc = tpl.pim_linear(x[:, 0, 0].cpu(), fc.to("cpu"), cfg=cfg)

    def banned(*a, **k):
        raise AssertionError("library kernel reached on the Eq. 1 path")

    for mod, name in ((torch, "matmul"), (torch, "_int_mm"), (F, "conv2d")):
        monkeypatch.setattr(mod, name, banned)
    ops.reset_launch_counts()
    got_conv = tpl.pim_conv2d(x, w, cfg=cfg, conv_mode="fused")
    got_fc = tpl.pim_linear(x[:, 0, 0], fc, cfg=cfg)
    assert ops.launch_counts() == {"bitplane_pack": 1,
                                   "bitserial_matmul_fused": 1,
                                   "bitserial_matmul_packed": 0,
                                   "conv2d_bitserial_fused": 1}
    np.testing.assert_array_equal(got_conv.cpu().numpy(), want_conv.numpy())
    np.testing.assert_allclose(got_fc.cpu().numpy(), want_fc.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [2, 8])
def test_cuda_backends_equal_and_popcount_launches_kernel_4(gen, monkeypatch,
                                                            bits):
    """The four Eq. 1 backends give the same P on the card; popcount does
    it with one pack and one packed-matmul launch and no library product."""
    from repro_torch.core import bitserial as tbs

    qa = _codes(gen, (300, 363), bits)
    pk = prepack(torch.randn((363, 96), generator=gen, device="cuda"), bits)
    want = tbs.int_matmul_prepacked(qa, pk, bits, "int-direct")
    for backend in ("mxu-plane", "cuda"):
        assert torch.equal(tbs.int_matmul_prepacked(qa, pk, bits, backend),
                           want), backend

    def banned(*a, **k):
        raise AssertionError("library kernel reached on the popcount path")

    monkeypatch.setattr(torch, "matmul", banned)
    ops.reset_launch_counts()
    got = tbs.int_matmul_prepacked(qa, pk, bits, "popcount")
    assert ops.launch_counts() == {"bitplane_pack": 1,
                                   "bitserial_matmul_fused": 0,
                                   "bitserial_matmul_packed": 1,
                                   "conv2d_bitserial_fused": 0}
    assert torch.equal(got, want)
