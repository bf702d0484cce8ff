"""The port's CUDA kernels on the card: each wrapper against its plain
version on the same CUDA tensors, the launch counters, the rule that a
CUDA tensor never reaches a library kernel for the Eq. 1 product or the
fused conv, and the RWKV-6 path through the WKV kernel. Marked ``cuda``: without a GPU every test here skips. This file
imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import pim_layers as tpl
from repro_torch.core.packed import prepack, prepack_conv
from repro_torch.kernels import _build
from repro_torch.kernels import bitplane_pack as kp
from repro_torch.kernels import bitserial_matmul as km
from repro_torch.kernels import conv2d_fused as kc
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_chunk as kw

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


@pytest.mark.parametrize("bits", range(1, 17))
@pytest.mark.parametrize("m,k", [(37, 70), (5, 3), (9, 64)])
def test_pack_kernel_equals_plain_at_every_width(gen, m, k, bits):
    """1-16 planes, K ragged, under a word and on words (the 16-byte
    loads); the full-width code and the bits above ``bits`` too."""
    q = torch.randint(-2**20, 2**20, (m, k), generator=gen, device="cuda",
                      dtype=torch.int32)
    q[0] = 2**bits - 1
    before = kp.launches
    got = kp.bitplane_pack(q, bits)
    assert kp.launches == before + 1
    assert torch.equal(got, kp.bitplane_pack_plain(q, bits))


def test_pack_kernel_at_the_stem_and_rejects_past_16_bits(gen):
    q = _codes(gen, (8 * 230 * 230, 3), 8)
    assert torch.equal(kp.bitplane_pack(q, 8), kp.bitplane_pack_plain(q, 8))
    q = _codes(gen, (8, 40), 8)
    with pytest.raises(ValueError, match="1..16"):
        kp.bitplane_pack(q, 17)
    assert torch.equal(kp.bitplane_pack(q[:, 1:], 8),        # unaligned rows
                       kp.bitplane_pack_plain(q[:, 1:], 8))


@pytest.mark.parametrize("bits", [2, 8, 12, 16])
def test_prepack_on_cuda_packs_through_kernel_1(gen, monkeypatch, bits):
    """prepack, prepack_conv (both layouts) and _pack_codes on the card
    launch kernel 1 for every pack, never the plain pack, and give the
    CPU's planes bit for bit."""
    from repro_torch.core import bitserial as tbs
    from repro_torch.core import bitslice

    lin = torch.randn((300, 70), generator=gen, device="cuda")
    conv = torch.randn((3, 3, 40, 24), generator=gen, device="cuda")
    qw = _codes(gen, (100, 24), bits)
    want = (prepack(lin.cpu(), bits), prepack_conv(conv.cpu(), bits))

    def banned(*a, **k):
        raise AssertionError("plain pack on the card")

    monkeypatch.setattr(bitslice, "slice_and_pack", banned)
    monkeypatch.setattr(bitslice, "pack_bits", banned)
    before = kp.launches
    pl, pc = prepack(lin, bits), prepack_conv(conv, bits)
    pq = tbs._pack_codes(qw, pl.wq)
    assert kp.launches == before + 4
    monkeypatch.undo()
    for got, ref in ((pl.planes, want[0].planes),
                     (pc.mat.planes, want[1].mat.planes),
                     (pc.fused_planes, want[1].fused_planes)):
        assert torch.equal(got.cpu(), ref)
    assert torch.equal(pq.planes.cpu(), tbs._pack_codes(qw.cpu(), pl.wq.to(
        "cpu")).planes)


@pytest.mark.parametrize("m,k,n", [(37, 70, 131), (8, 2048, 1000),
                                   (130, 576, 64)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_matmul_kernel_equals_plain(gen, m, k, n, bits):
    qa = _codes(gen, (m, k), bits)
    pw = prepack(torch.randn((k, n), generator=gen, device="cuda"), bits)
    assert torch.equal(km.bitserial_matmul_fused(qa, pw.planes, bits, bits),
                       km.bitserial_matmul_fused_plain(qa, pw.planes, bits,
                                                       bits))


@pytest.mark.parametrize("m,k,n", [
    # musicgen-large at a decode step of 4 frames: wq, wk, wv, wo and the
    # head (2,048 codes), w_in, w_out
    *[(4, k, n) for k, n in ((2048, 2048), (2048, 8192), (8192, 2048))],
    # llama-3.2-vision-90b at a decode step: wq / wo, wk / wv, w_in /
    # w_gate, w_out and the untied head
    *[(1, k, n) for k, n in ((8192, 8192), (8192, 1024), (8192, 28672),
                             (28672, 8192), (8192, 128256))],
    (6400, 8192, 1024)])   # a cross layer's wk / wv on one image's patches
def test_matmul_kernel_at_the_stub_frontend_archs_shapes(gen, m, k, n):
    """Kernel 2 at the new K x N of musicgen-large and the vision arch,
    the cross call at M = 6,400 included: equal to the plain version."""
    qa = _codes(gen, (m, k), 8)
    pw = prepack(torch.randn((k, n), generator=gen, device="cuda"), 8).planes
    assert torch.equal(km.bitserial_matmul_fused(qa, pw, 8, 8),
                       km.bitserial_matmul_fused_plain(qa, pw, 8, 8))


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


def _both_entries(qa, pw, a_bits, w_bits, entry):
    """(kernel, plain) P of kernel 2 (``fused``) or kernel 4 (``packed``)."""
    if entry == "fused":
        return (km.bitserial_matmul_fused(qa, pw, a_bits, w_bits),
                km.bitserial_matmul_fused_plain(qa, pw, a_bits, w_bits))
    pa = kp.bitplane_pack_plain(qa, a_bits)
    return (km.bitserial_matmul_packed(pa, pw, a_bits, w_bits),
            km.packed_matmul_plain(pa, pw))


@pytest.mark.parametrize("m,k,n", [
    *[(m, 2560, 2560) for m in (1, 5, 15, 16, 17, 63, 65)],
    (8, 363, 1000), (77, 4000, 96), (8, 70, 1000), (65, 2560, 8)])
@pytest.mark.parametrize("entry", ["fused", "packed"])
def test_matmul_kernels_across_tiles_and_k_splits(gen, m, k, n, entry):
    """Both entries on either side of the 16-row tile, with K split across
    blocks or not, K and N ragged: equal to the plain versions, and the same
    in a second launch (the splits' atomic sums are exact)."""
    qa = _codes(gen, (m, k), 8)
    pw = prepack(torch.randn((k, n), generator=gen, device="cuda"), 8).planes
    got, want = _both_entries(qa, pw, 8, 8, entry)
    assert torch.equal(got, want)
    assert torch.equal(_both_entries(qa, pw, 8, 8, entry)[0], got)


@pytest.mark.parametrize("entry", ["fused", "packed"])
def test_matmul_kernels_wrap_mod_2_32(gen, entry):
    """Every code 255 at <8:8>, K = 40,000: P = 65,025 * K passes 2^31 and
    one 32,768-K slab, and wraps like the reference's int32."""
    m, k, n = 8, 40000, 64
    qa = torch.full((m, k), 255, dtype=torch.int32, device="cuda")
    assert km._plan(m, n, k // 32, km._sm_count(qa.device)).splits > 1
    pw = kp.bitplane_pack_plain(torch.full((n, k), 255, dtype=torch.int32,
                                           device="cuda"), 8)
    got, want = _both_entries(qa, pw, 8, 8, entry)
    p = 65025 * k % 2**32
    assert torch.equal(got, want)
    assert (got == p - 2**32).all()


def test_matmul_library_reports_the_plans_tiles(gen):
    """The C library's tiles and slab are the ones ``_plan`` sizes grids
    and splits for."""
    lib = _build.load("bitserial_matmul", km._ARGTYPES)
    for variant, tile in enumerate(km.TILES):
        got = (ctypes.c_int * 4)()
        assert lib.repro_bitserial_matmul_tile(variant, got) == 0
        assert tuple(got) == (*tile, km.SLAB_WORDS)
    assert lib.repro_bitserial_matmul_tile(len(km.TILES), got) != 0
    assert sorted(km._entries()) == ["fused", "fused_batched", "packed"]


@pytest.mark.parametrize("e,m,k,n,bits", [
    (16, 8, 4096, 640, 8),         # a phi3.5-moe decode bank, N cut
    (3, 37, 70, 131, 8),           # M, K and N ragged against the tiles
    (3, 17, 300, 40, 4),           # few tiles: K split with atomics
    (3, 5, 2560, 96, 2),           # the 16-row tile, split K
    (2, 65, 33, 200, 8)])
def test_batched_kernel_equals_plain_and_single_launches(gen, e, m, k, n,
                                                         bits):
    """Kernel 2's batched entry on a bank prepacked on the card: equal to
    its plain version and to E single launches, the same in a second
    launch, one launch counted."""
    qa = _codes(gen, (e, m, k), bits)
    bank = prepack(torch.randn((e, k, n), generator=gen, device="cuda"), bits)
    ops.reset_launch_counts()
    got = km.bitserial_matmul_fused_batched(qa, bank.planes, bits, bits)
    assert ops.launch_counts()["bitserial_matmul_fused_batched"] == 1
    assert torch.equal(got, km.bitserial_matmul_fused_batched_plain(
        qa, bank.planes, bits, bits))
    assert torch.equal(got, torch.stack([km.bitserial_matmul_fused(
        qa[i], bank.planes[i], bits, bits) for i in range(e)]))
    assert torch.equal(km.bitserial_matmul_fused_batched(
        qa, bank.planes, bits, bits), got)


def test_batched_kernel_wraps_mod_2_32(gen):
    """Every code 255 at <8:8>, K = 40,000, two experts: each expert's P
    passes 2^31 and one slab and wraps like the reference's int32."""
    e, m, k, n = 2, 8, 40000, 64
    qa = torch.full((e, m, k), 255, dtype=torch.int32, device="cuda")
    pw = kp.bitplane_pack_plain(torch.full((e * n, k), 255, dtype=torch.int32,
                                           device="cuda"), 8)
    pw = pw.reshape(8, e, n, -1).transpose(0, 1).contiguous()
    got = km.bitserial_matmul_fused_batched(qa, pw, 8, 8)
    assert torch.equal(got, km.bitserial_matmul_fused_batched_plain(
        qa, pw, 8, 8))
    assert (got == 65025 * k % 2**32 - 2**32).all()


@pytest.mark.parametrize("bits", [4, 8])
def test_bank_prepack_on_cuda_packs_once_through_kernel_1(gen, bits):
    """An (E, K, N) bank prepacked on the card: one launch of kernel 1 for
    the whole bank, and codes, planes, column sums and each expert's wq
    equal to the CPU's prepack of the same weights."""
    w = torch.randn((5, 70, 131), generator=gen, device="cuda")
    ops.reset_launch_counts()
    got = prepack(w, bits)
    assert ops.launch_counts()["bitplane_pack"] == 1
    want = prepack(w.cpu(), bits)
    for name in ("codes", "planes", "col_sums"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert torch.equal(got.wq.scale.cpu(), want.wq.scale)
    assert torch.equal(got.wq.qmin.cpu(), want.wq.qmin)


def test_packed_moe_ffn_launches_one_batched_kernel_per_stage(gen,
                                                             monkeypatch):
    """The reduced phi3.5-moe's packed FFN on "cuda": three launches of the
    batched entry (w_in, w_gate, w_out) and none of the single entry; every
    bank product equal to the CPU's int-direct product of the same codes,
    the routing equal to the CPU's and the output close to it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig, bitserial
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm import moe as MOE

    cfg = dataclasses.replace(
        get_config("phi3.5-moe-42b-a6.6b").model.reduced(), dtype="float32",
        pim=PIMQuantConfig(8, 8, backend="cuda"))
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    real, calls = bitserial.int_matmul_prepacked_bank, []

    def spy(qa, w, a_bits, backend):
        out = real(qa, w, a_bits, backend)
        calls.append((qa.cpu(), w.to("cpu"), out.cpu()))
        return out

    pc = M.prepack_params(p, cfg.pim)
    want, aux_cpu = MOE.moe_ffn(pc, cfg, x)
    monkeypatch.setattr(bitserial, "int_matmul_prepacked_bank", spy)
    pg = M.prepack_params(M.to_device(p, "cuda"), cfg.pim)
    ops.reset_launch_counts()
    got, aux = MOE.moe_ffn(pg, cfg, x.cuda())
    counts = ops.launch_counts()
    assert counts["bitserial_matmul_fused_batched"] == len(calls) == 3
    assert counts["bitserial_matmul_fused"] == 0
    for qa, w, out in calls:
        assert torch.equal(out, real(qa, w, 8, "int-direct"))
    assert float(aux["drop"]) == float(aux_cpu["drop"])
    assert (got.cpu() - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.parametrize("ab,wb", [(3, 5), (1, 8), (7, 2)])
def test_fused_kernel_keeps_the_low_a_bits(gen, ab, wb):
    """Codes wider than a_bits: the kernel keeps their low a_bits bits, the
    bits the plain version (and the Pallas kernel) slices."""
    qa = _codes(gen, (20, 300), 8)
    pw = prepack(torch.randn((300, 40), generator=gen, device="cuda"),
                 wb).planes
    got = km.bitserial_matmul_fused(qa, pw, ab, wb)
    assert torch.equal(got, km.bitserial_matmul_fused_plain(qa, pw, ab, wb))
    assert torch.equal(got, km.bitserial_matmul_fused(qa & (2**ab - 1), pw,
                                                      ab, wb))


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


def _conv_operands(gen, shape, o, ks, pad, ab, wb):
    """Random codes padded with the zero code, packed along C, and
    prepacked weight planes: (pa, pw, hp, wp)."""
    qx = F.pad(_codes(gen, shape, ab), (0, 0, pad, pad, pad, pad))
    n, hp, wp, c = qx.shape
    pw = prepack_conv(torch.randn((ks, ks, c, o), generator=gen,
                                  device="cuda"), wb).fused_planes
    pa = kp.bitplane_pack_plain(qx.reshape(n * hp * wp, c), ab).reshape(
        ab, n * hp, wp, -1)
    return pa, pw, hp, wp


@pytest.mark.parametrize("shape,o,ks,stride,pad", [
    ((2, 224, 224, 3), 64, 7, 2, 3),       # ResNet stem 7x7/2, no K split
    ((1, 64, 64, 3), 96, 11, 4, 2),        # AlexNet conv1 11x11/4
    ((1, 32, 32, 3), 64, 3, 1, 1),         # VGG19 conv1_1
    ((2, 14, 14, 64), 64, 3, 1, 1),        # ResNet s0 3x3
    ((2, 14, 14, 128), 128, 3, 2, 1),      # ResNet s1b0.c2 3x3/2
    ((2, 13, 13, 96), 256, 5, 1, 2),       # AlexNet conv2 5x5
    ((1, 7, 7, 512), 512, 3, 1, 1),        # VGG19 conv5_1, K split
    ((2, 9, 9, 5), 131, 3, 2, 1),          # narrow, ragged O
    ((2, 9, 9, 40), 131, 3, 1, 1),         # wide, C off the word
    ((1, 10, 10, 31), 70, 5, 4, 2),        # narrow, two K groups a row
    ((1, 9, 13, 33), 16, 3, 2, 1)])        # wide, one lane past a word
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_conv_kernel_served_and_ragged_rows(gen, shape, o, ks, stride, pad,
                                            bits):
    """Reduced served rows and ragged ones, at each paper precision, with
    the channel count given (C < 32 takes the narrow variant)."""
    pa, pw, hp, wp = _conv_operands(gen, shape, o, ks, pad, bits, bits)
    geo = dict(n=shape[0], hp=hp, oh=(hp - ks) // stride + 1,
               ow=(wp - ks) // stride + 1, stride=stride)
    assert torch.equal(kc.conv2d_bitserial_fused(pa, pw, c=shape[-1], **geo),
                       kc.conv2d_fused_plain(pa, pw, **geo))


@pytest.mark.parametrize("shape,o,ks,stride,pad", [
    ((1, 7, 7, 512), 512, 3, 1, 1), ((2, 20, 20, 3), 64, 7, 2, 3),
    ((1, 12, 12, 96), 96, 5, 1, 2)])
def test_conv_kernel_split_and_whole_agree(gen, monkeypatch, shape, o, ks,
                                           stride, pad):
    """The same conv launched whole (one K range, plain stores) and split
    into one range a pair (uint32 atomics into a zeroed output): both equal
    the plain version, and a plan the C entry cannot sum exactly (a range
    past one slab) is refused, not run."""
    pa, pw, hp, wp = _conv_operands(gen, shape, o, ks, pad, 8, 8)
    n, c = shape[0], shape[-1]
    geo = dict(n=n, hp=hp, oh=(hp - ks) // stride + 1,
               ow=(wp - ks) // stride + 1, stride=stride)
    want = kc.conv2d_fused_plain(pa, pw, **geo)
    real = kc._plan
    plan = real(n * geo["oh"], geo["ow"], pa.shape[-1], c, o, ks, ks, stride,
                km._sm_count(pa.device))
    pairs = ks * (1 if plan.variant == kc.NARROW else -(-pa.shape[-1]
                                                        // plan.ks))
    for split_pairs, splits in ((pairs, 1), (1, pairs)):
        monkeypatch.setattr(kc, "_plan", lambda *a: plan._replace(
            split_pairs=split_pairs, splits=splits))
        assert torch.equal(kc.conv2d_bitserial_fused(pa, pw, c=c, **geo),
                           want)
    monkeypatch.setattr(kc, "_plan", lambda *a: plan._replace(
        split_pairs=kc.SLAB_WORDS + 1, splits=1))
    with pytest.raises(RuntimeError, match="conv2d_bitserial_fused"):
        kc.conv2d_bitserial_fused(pa, pw, c=c, **geo)


def test_conv_kernel_wraps_mod_2_32(gen):
    """Every code 255 at <8:8>, a 3x3 kernel over a 3x3 map, C = 3,712: K =
    33,408 passes one 32,768-K slab and P = 65,025 * K passes 2^31; the
    kernel wraps like the reference's int32."""
    c, o = 3712, 8
    pa = kp.bitplane_pack_plain(torch.full((9, c), 255, dtype=torch.int32,
                                           device="cuda"), 8).reshape(
        8, 3, 3, -1)
    pw = kp.bitplane_pack_plain(torch.full((9 * o, c), 255,
                                           dtype=torch.int32, device="cuda"),
                                8).reshape(8, 3, o, 3, -1)
    pw = pw.permute(1, 0, 2, 3, 4).contiguous()
    geo = dict(n=1, hp=3, oh=1, ow=1, stride=1)
    got = kc.conv2d_bitserial_fused(pa, pw, c=c, **geo)
    p = 65025 * 9 * c % 2**32
    assert torch.equal(got, kc.conv2d_fused_plain(pa, pw, **geo))
    assert (got == p - 2**32).all()


def test_conv_wrapper_holds_each_plans_shared_memory_to_the_library(
        gen, monkeypatch):
    """The wrapper holds its count of a new plan's shared memory equal to
    the C library's before the launch, and refuses the plan where the two
    differ."""
    pa, pw, hp, wp = _conv_operands(gen, (1, 7, 7, 64), 64, 3, 1, 8, 8)
    geo = dict(n=1, hp=hp, oh=hp - 2, ow=wp - 2, stride=1)
    want = kc.conv2d_fused_plain(pa, pw, **geo)
    kc._hold_smem.cache_clear()
    assert torch.equal(kc.conv2d_bitserial_fused(pa, pw, c=64, **geo), want)
    kc._hold_smem.cache_clear()
    monkeypatch.setattr(kc, "smem_bytes", lambda *a: 0)
    with pytest.raises(RuntimeError, match="shared memory"):
        kc.conv2d_bitserial_fused(pa, pw, c=64, **geo)


def test_conv_library_reports_the_plans_geometry(gen):
    """The C library's tile, ring, slab and shared-memory limit are the
    ones ``_plan`` sizes for, and it computes every chip_smoke.py row's
    shared memory as ``smem_bytes`` does."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lib = _build.load("conv2d_fused", kc._ARGTYPES)
    got = (ctypes.c_int * 6)()
    assert lib.repro_conv2d_fused_tile(got) == 0
    assert tuple(got) == (kc.BM, kc.BN, kc.WIDE_STAGES, kc.MAX_STAGES,
                          kc.SLAB_WORDS, kc.SMEM_LIMIT)
    for n, h, c, o, ks, stride, pad in (smoke.CONV_ROWS
                                        + smoke.RAGGED_CONV_ROWS):
        oh = (h + 2 * pad - ks) // stride + 1
        plan = kc._plan(n * oh, oh, -(-c // 32), c, o, ks, ks, stride, 132)
        geometry = (plan.variant, plan.tw, plan.tr, plan.ks,
                    plan.split_pairs, plan.stages, stride, ks, c)
        assert lib.repro_conv2d_fused_smem(*geometry) == \
            kc.smem_bytes(*geometry)


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
                                   "bitserial_matmul_fused_batched": 0,
                                   "conv2d_bitserial_fused": 1,
                                   "wkv_chunked": 0}
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
                                   "bitserial_matmul_fused_batched": 0,
                                   "conv2d_bitserial_fused": 0,
                                   "wkv_chunked": 0}
    assert torch.equal(got, want)


def _wkv_inputs(gen, bh, s, d):
    """The reference test's distributions (tests/test_kernels.py)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (randn(bh, s, d) * 0.5 for _ in range(3))
    lw = torch.clamp_min(-torch.exp(randn(bh, s, d) - 2), -5.0)
    return r, k, v, lw, randn(bh, d) * 0.2, randn(bh, d, d) * 0.1


@pytest.mark.parametrize("bh,s,d,chunk", [
    (2, 32, 8, 8), (6, 64, 16, 16), (1, 48, 32, 16), (4, 128, 16, 32),
    (3, 80, 64, 16), (2, 96, 64, 32), (5, 40, 8, 8),
    (40, 16, 64, 16), (40, 64, 64, 16), (40, 256, 64, 16),  # rwkv6-3b
    (40, 512, 64, 16), (80, 256, 64, 16)])
def test_wkv_kernel_equals_plain(gen, bh, s, d, chunk):
    """Kernel 5 against its plain chunked version and the sequential scan
    at the reference's tolerances: y relative 1e-4, state absolute 1e-3."""
    a = _wkv_inputs(gen, bh, s, d)
    before = kw.launches
    y, s_fin = kw.wkv_chunked(*a, chunk=chunk)
    assert kw.launches == before + 1
    for y_want, s_want in (kw.wkv_chunked_plain(*a, chunk),
                           kw.wkv_chunked_ref(*a)):
        rel = (y - y_want).abs().max() / (y_want.abs().max() + 1e-9)
        assert rel < 1e-4
        assert (s_fin - s_want).abs().max() < 1e-3


@pytest.mark.parametrize("h,s,d", [(40, 256, 64), (8, 48, 32)])
def test_wkv_kernel_reads_strided_views(gen, h, s, d):
    """(H, S, D) views of (1, S, H, D) tensors, the batch-1 prefill's
    layout: read in place, y written back in that layout, equal to the
    plain version on the same views."""
    def view():
        return torch.randn((1, s, h, d), generator=gen,
                           device="cuda").permute(0, 2, 1, 3).reshape(h, s, d)
    r, k, v = (view() * 0.5 for _ in range(3))
    lw = torch.clamp_min(-torch.exp(view() - 2), -5.0)
    assert r.stride() == (d, h * d, 1)
    a = (r, k, v, lw, torch.randn((h, d), generator=gen, device="cuda") * 0.2,
         torch.randn((h, d, d), generator=gen, device="cuda") * 0.1)
    y, s_fin = kw.wkv_chunked(*a, chunk=16)
    assert y.stride() == r.stride()
    y_want, s_want = kw.wkv_chunked_plain(*a, 16)
    rel = (y - y_want).abs().max() / (y_want.abs().max() + 1e-9)
    assert rel < 1e-4
    assert (s_fin - s_want).abs().max() < 1e-3


def test_wkv_library_reports_the_plans_shared_memory(gen):
    lib = kw._library()
    for bh, s, d, chunk in ((40, 256, 64, 16), (80, 512, 64, 16),
                            (40, 16, 64, 16), (1, 48, 32, 16),
                            (5, 40, 8, 8), (4, 128, 16, 32)):
        plan = kw._plan(bh, s, d, chunk, kw._sm_count(torch.device("cuda")))
        assert lib.repro_wkv_chunked_smem(d, plan.cols, plan.tokens, chunk) \
            == kw.smem_bytes(d, plan.cols, plan.tokens, chunk)


def test_wkv_kernel_rejects_what_it_does_not_take(gen):
    a = _wkv_inputs(gen, 2, 40, 16)
    with pytest.raises(ValueError, match="multiple"):
        kw.wkv_chunked(*a, chunk=16)
    a = _wkv_inputs(gen, 2, 32, 48)
    with pytest.raises(ValueError, match="head dim"):
        kw.wkv_chunked(*a, chunk=16)


def _reduced_rwkv(**kw_):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("rwkv6-3b").model.reduced(),
                               dtype="float32", **kw_)


def test_rwkv_time_mix_launches_kernel_5_per_chunked_prefill(gen):
    """On CUDA tensors a prefill chunk of 16 or 32 tokens runs kernel 5
    once, 8 tokens and a decode step run the token loop, and the chunked
    result matches the CPU's plain version of the same weights."""
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm import rwkv6 as RW

    cfg = _reduced_rwkv()
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    blk = {k: v[0] for k, v in params["scan"][0]["time_mix"].items()}
    blk_gpu = {k: v.cuda() for k, v in blk.items()}
    for s, want_launches in ((32, 1), (16, 1), (8, 0), (1, 0)):
        x = torch.randn((2, s, cfg.d_model), generator=gen, device="cuda")
        ops.reset_launch_counts()
        y, _ = RW.rwkv_time_mix(blk_gpu, cfg, x)
        assert ops.launch_counts()["wkv_chunked"] == want_launches, s
        y_cpu, _ = RW.rwkv_time_mix(blk, cfg, x.cpu())
        np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pim", [None, "cuda"])
def test_serve_engine_on_cuda_matches_cpu_tokens(gen, pim):
    """The reduced rwkv6-3b (float32) served on the card and on the CPU
    from the same weights, prompts whose chunks reach kernel 5 (48 = 32 +
    16) and the token loop (13 = 8 + 4 + 1): on the float path equal greedy
    tokens; with <8:8> on the "cuda" backend kernels 2 and 5 both launch."""
    from repro_torch.core import PIMQuantConfig
    from repro_torch.models.lm import model as M
    from repro_torch.serving import Request, SamplerConfig, ServeEngine

    cfg = _reduced_rwkv(pim=PIMQuantConfig(8, 8, backend=pim) if pim
                        else None)
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab, n).astype(
        np.int32) for i, n in enumerate((48, 13))]
    out = {}
    for device in ("cuda", "cpu"):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=64,
                          sampler=SamplerConfig(temperature=0.0),
                          device=device)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
        ops.reset_launch_counts()
        out[device] = {c.rid: c.tokens for c in eng.run(strict=True)}
        if device == "cuda":
            counts = ops.launch_counts()
    assert counts["wkv_chunked"] == cfg.n_layers * 2
    assert bool(counts["bitserial_matmul_fused"]) == (pim == "cuda")
    if pim is None:
        assert out["cuda"] == out["cpu"]
    else:
        # Quantized, float jitter between the card and the CPU flips a few
        # activation codes, which may part the tokens at near-ties; the
        # logits are held close in test_pim_lm_on_cuda_close_to_cpu.
        assert all(len(v) == 4 for v in out["cuda"].values())


def test_pim_lm_on_cuda_close_to_cpu(gen, monkeypatch):
    """One reduced rwkv6-3b layer at <8:8> on "cuda", float32, the same
    weights on the card and on the CPU: two prompts (48 = 32 + 16, 20 = 16
    + 4) prefilled chunk by chunk into a 4-slot grid, then two decode steps
    at M = 4 on the same tokens. One float ulp of jitter flips an
    activation code and the next layers spread it (1-3% of the logits in
    relative L2 on the CPU alone), so: the planes prepacked on the card
    equal the CPU's bit for bit; every quantized product of the card's run
    recomputed on the CPU from the same input agrees within 1e-5 of its
    largest (the same codes, the same integer P); the logits agree within
    0.1 in relative L2 per row, where a wiring fault gives O(1)."""
    from repro_torch.core import PIMQuantConfig, pim_layers
    from repro_torch.core.packed import PackedWeight
    from repro_torch.models.lm import model as M
    from repro_torch.serving.engine import _pow2_chunks

    cfg = _reduced_rwkv(n_layers=1, pim=PIMQuantConfig(8, 8, backend="cuda"))
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (48, 20)]
    real, calls = pim_layers.quantized_matmul, []

    def spy(a, w, **kw):
        y = real(a, w, **kw)
        calls.append((a.cpu(), w.to("cpu"), kw, y.cpu()))
        return y

    toks, out, packed = None, {}, {}
    for device in ("cpu", "cuda"):
        if device == "cuda":
            monkeypatch.setattr(pim_layers, "quantized_matmul", spy)
        ops.reset_launch_counts()
        p = packed[device] = M.prepack_params(M.to_device(params, device),
                                              cfg.pim)
        st = M.init_state(cfg, 4, 64, device)
        got = []
        for slot, prompt in enumerate(prompts):
            pos = 0
            for c in _pow2_chunks(len(prompt)):
                lo, st = M.prefill_into_slot(
                    p, cfg, torch.from_numpy(prompt[pos:pos + c])[None].to(
                        device), st, slot, pos)
                pos += c
            got.append(lo[:, 0].cpu().numpy())
        if toks is None:
            toks = [np.array([int(g.argmax()) for g in got] + [0, 0])]
        for step in range(2):
            lo, st = M.decode_step(p, cfg, torch.from_numpy(
                toks[step])[:, None].to(device), st)
            got.append(lo[:, 0].cpu().numpy())
            if len(toks) == step + 1:
                toks.append(got[-1].argmax(-1))
        out[device] = got
    counts = ops.launch_counts()
    assert counts["wkv_chunked"] == 3
    assert counts["bitserial_matmul_fused"] == len(calls) == 6 * 9

    def leaves(tree, path=""):
        if isinstance(tree, PackedWeight):
            yield path, tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")

    want, got = (dict(leaves(packed[d])) for d in ("cpu", "cuda"))
    assert sorted(got) == sorted(want) and len(want) == 9
    for path, w in want.items():
        g = got[path].to("cpu")
        for name in ("codes", "planes", "col_sums"):
            assert torch.equal(getattr(w, name), getattr(g, name)), path
        assert torch.equal(w.wq.scale, g.wq.scale), path
        assert torch.equal(w.wq.qmin, g.wq.qmin), path
    for a, w, kw, y in calls:
        y_cpu = real(a, w, **kw)
        assert (y - y_cpu).abs().max() <= 1e-5 * y_cpu.abs().max()
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.shape == c.shape
        rel = np.linalg.norm(g - c, axis=-1) / np.linalg.norm(c, axis=-1)
        assert rel.max() < 0.1


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quant_and_its_ste_gradient_equal_cpu(gen, axis, dtype):
    """fake_quant's forward and straight-through gradient on the card equal
    the CPU's bit for bit (min/max, a true division by a device tensor,
    round half to even, the halved gradient at the bounds)."""
    from repro_torch.core.quantize import fake_quant

    x = (torch.randn((300, 70), generator=gen, device="cuda") * 3).to(dtype)
    g = torch.randn((300, 70), generator=gen, device="cuda").to(dtype)
    out = {}
    for dev in ("cuda", "cpu"):
        xi = x.detach().to(dev, copy=True).requires_grad_(True)
        y = fake_quant(xi, 8, axis=axis)
        y.backward(g.to(dev))
        out[dev] = (y.detach().cpu(), xi.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


def test_adamw_step_on_cuda_matches_cpu(gen):
    """One AdamW step of a reduced llama3.2-3b tree (bf16 params, float32
    masters; clipped gradients) on the card and on the CPU: m, v and the
    masters within rtol 1e-5 (the clip scale carries each device's order of
    summing the squares; the card's pow and cos may sit an ulp off)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as M
    from repro_torch.training import optimizer as O

    cfg = get_config("llama3.2-3b").model.reduced(n_layers=2)
    params = M.cast_params(M.init(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"), torch.bfloat16)
    grads = M._map(lambda p: torch.randn(p.shape, generator=torch.Generator(
        ).manual_seed(p.numel())).to(p.dtype), params)
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    res = {}
    for dev in ("cuda", "cpu"):
        p = M.to_device(params, dev)
        _, state, m = O.apply_updates(ocfg, p, M.to_device(grads, dev),
                                      O.init_opt_state(ocfg, p))
        res[dev] = (state, m)
    (sg, mg), (sc, mc) = res["cuda"], res["cpu"]
    assert float(mg["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]),
                               rtol=1e-5)
    for name in ("m", "v", "master"):
        for a, b in zip(O.leaves(sg[name]), O.leaves(sc[name])):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-9)


def test_rwkv_training_on_cuda_raises_until_kernel_5_has_a_backward(gen):
    """Kernel 5 has no backward: rwkv6's chunked WKV on CUDA tensors that
    need a gradient raises NotImplementedError naming its ROADMAP item, and
    launches nothing (no fall back to the plain version); without a
    gradient it runs kernel 5."""
    from repro_torch.models.lm import rwkv6 as RW

    b, s, h, d = 1, 32, 4, 32
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
               for _ in range(3))
    w = torch.rand((b, s, h, d), generator=gen, device="cuda") * 0.5 + 0.4
    u = torch.randn((h, d), generator=gen, device="cuda")
    s0 = torch.zeros((b, h, d, d), device="cuda")
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="Queue 1, item 10"):
        RW._chunked_wkv(r.requires_grad_(True), k, v, w, u, s0, 16)
    assert ops.launch_counts()["wkv_chunked"] == 0
    with torch.no_grad():
        RW._chunked_wkv(r, k, v, w, u, s0, 16)
    assert ops.launch_counts()["wkv_chunked"] == 1
