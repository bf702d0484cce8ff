"""Kernel 3's launch plan (``kernels/conv2d_fused.py::_plan``) at every
conv row ``chip_smoke.py`` holds it at, at every call the served models give
it at 224 px (``SERVED_CONVS``, itself held to what the models run) and at
the edges of its tiles, and the plain version's wrap mod 2^32 against the
JAX package once K passes 32,768 codes (where a block's s32 sum would no
longer be exact).

The plan decides what the CUDA kernel sums in s32, what it adds with uint32
atomics and how much shared memory a block takes, so it is checked here
where no card is: its tiles cover the output, the narrow variant (taps
packed into the K groups) is taken exactly when C < 32, no block sums more
than 1,024 words, and two blocks fit an SM."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bits_equal, t

from repro.kernels import ops as jops
from repro_torch.core.pim_layers import fuse_conv_heuristic
from repro_torch.kernels import conv2d_fused as kc
from repro_torch.kernels import ops as tops
from repro_torch.models.cnn import alexnet, layers, resnet, vgg


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()
H100_SMS = 132
SM_BYTES = 228 * 1024        # shared memory of an SM; 1 KB kept a block


def _row(n, h, c, o, ks, stride, pad):
    """(N*OH, OW, CW, C, O, KH, KW, stride) of a square conv."""
    oh = (h + 2 * pad - ks) // stride + 1
    return (n * oh, oh, -(-c // 32), c, o, ks, ks, stride)


# chip_smoke.py's rows, the served calls, then the edges: OW of 1, 7, 13
# and around the 128-pixel tile; O of 1, 96, 131 and around the 64-channel
# tile; C on either side of a word and of the narrow variant; strides 1, 2,
# 4 with 3x3 and 11x11 kernels.
_SERVED = [(n * oh, oh, -(-c // 32), c, o, k, k, s)
           for model in _SMOKE.SERVED_CONVS
           for n, _, c, o, k, s, oh in _SMOKE.served_conv_calls(model)]
_ROWS = ([_row(*r) for r in _SMOKE.CONV_ROWS + _SMOKE.RAGGED_CONV_ROWS]
         + [_row(*_SMOKE.CONV_WRAP_ROW, 1, 0)] + _SERVED
         + [(2 * ow, ow, 2, 64, 64, 3, 3, 1) for ow in (1, 7, 13, 127, 128,
                                                         129)]
         + [(8 * 14, 14, 4, 128, o, 3, 3, 1) for o in (1, 63, 64, 65, 96,
                                                        131)]
         + [(8 * 14, 14, -(-c // 32), c, 64, 3, 3, 1)
            for c in (3, 5, 31, 32, 33, 40)]
         + [(4 * ow, ow, -(-c // 32), c, 96, ks, ks, s)
            for s, ow in ((1, 56), (2, 28), (4, 55)) for c in (3, 31, 40)
            for ks in (3, 11)])


def _pairs(plan, cw, kh):
    """The contraction's pairs: (kh, step) for the wide variant, kh for the
    narrow one."""
    return kh * (1 if plan.variant == kc.NARROW else -(-cw // plan.ks))


@pytest.mark.parametrize("row", _ROWS)
@pytest.mark.parametrize("sms", [H100_SMS, 114])    # SXM and PCIe H100
def test_plan_tiles_the_conv_within_slabs_and_shared_memory(row, sms):
    n_oh, ow, cw, c, o, kh, kw, stride = row
    plan = kc._plan(*row, sms)
    # Tiles: at most BM pixels, no wider than the map, covering every row
    # and column; the grid's y covers O in BN-channel tiles.
    assert 1 <= plan.tw <= ow and 1 <= plan.tr <= n_oh
    assert plan.tw * plan.tr <= kc.BM
    m_tiles = -(-n_oh // plan.tr) * -(-ow // plan.tw)
    assert -(-n_oh // plan.tr) * plan.tr >= n_oh
    assert -(-ow // plan.tw) * plan.tw >= ow
    assert -(-o // kc.BN) * kc.BN >= o
    assert 1 <= plan.m_blocks <= m_tiles
    if plan.variant == kc.WIDE:
        assert plan.m_blocks == m_tiles and plan.stages == kc.WIDE_STAGES
        assert 1 <= plan.ks <= kc.MAX_KS
    else:
        assert plan.stages in (kc.WIDE_STAGES, kc.MAX_STAGES)
    # The narrow variant exactly when C < 32.
    assert plan.variant == (kc.NARROW if c < 32 else kc.WIDE)
    # The splits tile the pairs, and none sums more than a slab.
    pairs = _pairs(plan, cw, kh)
    assert (plan.splits - 1) * plan.split_pairs < pairs
    assert plan.splits * plan.split_pairs >= pairs
    words = -(-kw * c // 32) if plan.variant == kc.NARROW else kw * plan.ks
    assert plan.split_pairs * words <= kc.SLAB_WORDS
    assert 32 * plan.split_pairs * words <= 32768
    # Shared memory admits two blocks an SM.
    smem = kc.smem_bytes(plan.variant, plan.tw, plan.tr, plan.ks,
                         plan.split_pairs, plan.stages, stride, kw, c)
    assert smem <= kc.SMEM_LIMIT
    assert 2 * (smem + 1024) <= SM_BYTES


def test_plan_on_the_served_rows():
    """The served rows: the stem, AlexNet conv1 and VGG19 conv1_1 (C = 3)
    take the narrow variant with every kernel row's weights resident (one
    K range), a 7-pixel-wide map fills 126 of a tile's 128 rows where
    shared memory allows, and the wrap row, past one slab, is split."""
    plans = {r[:6]: kc._plan(*_row(*r), H100_SMS) for r in _SMOKE.CONV_ROWS}
    for key, plan in plans.items():
        assert plan.variant == (kc.NARROW if key[2] == 3 else kc.WIDE)
        if key[2] == 3:
            assert plan.splits == 1
    s3 = kc._plan(8 * 7, 7, 2, 64, 64, 3, 3, 1, H100_SMS)
    assert s3.tw * s3.tr == 126
    wrap = kc._plan(*_row(*_SMOKE.CONV_WRAP_ROW, 1, 0), H100_SMS)
    assert wrap.splits > 1


@pytest.mark.parametrize("model", ["resnet50", "alexnet", "vgg19"])
def test_served_convs_are_the_models_convs(model, monkeypatch):
    """``SERVED_CONVS`` lists every conv larger than 1x1 the model runs on
    a 224-px image, and at a bucket of 8 kernel 3 takes 17, 5 and 16 of the
    model's convs, its launches a bucket on the served path."""
    module = {"resnet50": resnet, "alexnet": alexnet, "vgg19": vgg}[model]
    seen = []
    conv_block = layers.conv_block

    def spy(p, x, stride=1, padding=0, cfg=None, relu=True, train=False):
        kh, kw, c, o = p["w"].shape
        if kh * kw > 1:
            seen.append((x.shape[1], c, o, kh, stride, padding))
        return conv_block(p, x, stride, padding, cfg, relu, train)

    monkeypatch.setattr(layers, "conv_block", spy)
    params = module.init(torch.Generator().manual_seed(0), num_classes=10,
                         image=224)
    with torch.no_grad():
        module.apply(params, torch.zeros(1, 224, 224, 3))
    assert sorted(set(seen)) == sorted(_SMOKE.SERVED_CONVS[model])
    fused = sum(fuse_conv_heuristic(8, oh, oh, k, k, c, "cuda")
                for h, c, _, k, s, p in seen
                for oh in [(h + 2 * p - k) // s + 1])
    assert fused == {"resnet50": 17, "alexnet": 5, "vgg19": 16}[model]


def test_plan_refuses_a_kernel_row_past_a_slab():
    """A kernel row wider than 1,024 words (300 taps of 4 words) cannot be
    summed exactly by one block: the plan raises instead of planning it."""
    with pytest.raises(ValueError, match="passes 1024 words"):
        kc._plan(1, 1, 4, 128, 8, 1, 300, 1, H100_SMS)


@pytest.mark.parametrize("o", [2, 5])
def test_plain_conv_wraps_like_the_reference(o):
    """All codes 255 at <8:8>, a 3x3 kernel over a 3x3 map, pad 0, C =
    3,712: K = 33,408 and P = 65,025 * K passes 2^31. The port's plain
    version wraps mod 2^32 bit for bit as the JAX package's Pallas kernel
    (interpret mode) does."""
    n, h, c, ks = 1, 3, 3712, 3
    qx = np.full((n, h, h, c), 255, np.int32)
    qw = np.full((ks * o * ks, c), 255, np.int32)      # (kh, o, kw) rows
    jpw = jnp.transpose(jops.pack_planes(jnp.asarray(qw), 8).reshape(
        8, ks, o, ks, -1), (1, 0, 2, 3, 4))
    tpw = tops.pack_planes(t(qw), 8).reshape(8, ks, o, ks, -1).permute(
        1, 0, 2, 3, 4).contiguous()
    assert_bits_equal(tpw, jpw)
    want = jops.conv2d_bitserial(jnp.asarray(qx), jpw, a_bits=8)
    got = tops.conv2d_bitserial(t(qx), tpw, a_bits=8)
    p = 65025 * ks * ks * c % 2**32
    assert int(np.asarray(want).ravel()[0]) == p - 2**32 < 0
    assert_bits_equal(got, want)
