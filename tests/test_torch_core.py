"""Port parity, core: Eq. 2 quantization, bit-plane packing and prepacked
weights of ``repro_torch`` against the JAX package on the same numpy inputs.
Integers (codes, QuantParams, planes, column sums) must be equal bit for
bit; there is no tolerance."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bits_equal, assert_close, n, t

jq = importlib.import_module("repro.core.quantize")
jbs = importlib.import_module("repro.core.bitslice")
jpk = importlib.import_module("repro.core.packed")
tq = importlib.import_module("repro_torch.core.quantize")
tbs = importlib.import_module("repro_torch.core.bitslice")
tpk = importlib.import_module("repro_torch.core.packed")


def _x(shape, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + offset).astype(np.float32)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape,offset", [((7, 70), 0.0), ((2, 5, 9, 3), 3.0),
                                          ((1000,), -2.0)])
def test_quantize_codes_and_params_bit_exact(bits, shape, offset):
    x = _x(shape, seed=bits, offset=offset)
    jp = jq.calibrate_minmax(jnp.asarray(x), bits)
    tp = tq.calibrate_minmax(t(x), bits)
    assert tp.bits == jp.bits == bits
    assert_bits_equal(tp.scale, jp.scale)
    assert_bits_equal(tp.qmin, jp.qmin)
    assert_bits_equal(tq.quantize(t(x), tp), jq.quantize(jnp.asarray(x), jp))
    codes = tq.quantize(t(x), tp)
    assert_bits_equal(tq.dequantize(codes, tp),
                      jq.dequantize(jnp.asarray(n(codes)), jp))


def test_quantize_rounds_half_to_even_and_guards_constant_input():
    """A constant tensor keeps a positive scale (finfo.tiny guard), and codes
    at an exact .5 round to even, as jnp.round does.

    The guarded scale tiny/255 is a float32 denormal, which XLA on the CPU
    flushes to 0; the port keeps it. Codes and dequantized values agree."""
    x = np.full((4, 4), 1.25, np.float32)
    tp = tq.calibrate_minmax(t(x), 8)
    jp = jq.calibrate_minmax(jnp.asarray(x), 8)
    assert float(tp.scale) > 0
    assert float(tp.scale) == np.float32(np.finfo(np.float32).tiny) / 255
    assert_bits_equal(tq.quantize(t(x), tp), jq.quantize(jnp.asarray(x), jp))
    assert_bits_equal(tq.dequantize(tq.quantize(t(x), tp), tp),
                      jq.dequantize(jq.quantize(jnp.asarray(x), jp), jp))
    x = np.array([0.0, 0.5, 1.5, 2.5, 3.0], np.float32)   # scale 1 at 2 bits
    tp = tq.calibrate_minmax(t(x), 2)
    assert tq.quantize(t(x), tp).tolist() == [0, 0, 2, 2, 3]
    assert_bits_equal(tq.quantize(t(x), tp),
                      jq.quantize(jnp.asarray(x), jq.calibrate_minmax(
                          jnp.asarray(x), 2)))


def test_fold_batchnorm_and_affine_correction():
    rng = np.random.default_rng(3)
    g, b, m = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    for got, want in zip(tq.fold_batchnorm(t(g), t(b), t(m), t(v)),
                         jq.fold_batchnorm(*map(jnp.asarray, (g, b, m, v)))):
        assert_bits_equal(got, want)
    p = rng.integers(-2**20, 2**20, (5, 16)).astype(np.int32)
    sa = rng.integers(0, 5000, (5, 1)).astype(np.int32)
    sw = rng.integers(0, 5000, (16,)).astype(np.int32)
    a, w = _x((5, 40), 4), _x((40, 16), 5)
    ja, jw = jq.calibrate_minmax(jnp.asarray(a), 8), jq.calibrate_minmax(
        jnp.asarray(w), 4)
    ta, tw = tq.calibrate_minmax(t(a), 8), tq.calibrate_minmax(t(w), 4)
    for k in (40, np.full((5, 1), 37.0, np.float32)):
        got = tq.affine_correction(t(p), t(sa), t(sw),
                                   k if isinstance(k, int) else t(k), ta, tw)
        want = jq.affine_correction(jnp.asarray(p), jnp.asarray(sa),
                                    jnp.asarray(sw), k, ja, jw)
        assert_close(got, want)


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("shape", [(4, 32), (3, 70), (2, 3, 100), (1, 5)])
def test_bitslice_planes_bit_exact(bits, shape):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 2**bits, shape).astype(np.int32)
    assert_bits_equal(tbs.bitplanes(t(q), bits),
                      jbs.bitplanes(jnp.asarray(q), bits))
    packed = tbs.slice_and_pack(t(q), bits)
    assert_bits_equal(packed, jbs.slice_and_pack(jnp.asarray(q), bits))
    for plane in range(bits):
        assert_bits_equal(tbs.unpack_bits(packed[plane], shape[-1]),
                          (q >> plane) & 1)


def test_pack_bits_high_lane_and_popcount():
    """Bit 31 (the int32 sign bit) packs and counts like any other lane."""
    b = np.zeros((2, 64), np.int32)
    b[0, 31] = b[1, 0] = b[1, 63] = 1
    b[1, 32:] = 1
    got = tbs.pack_bits(t(b))
    assert_bits_equal(got, jbs.pack_bits(jnp.asarray(b)))
    assert tbs.popcount(got).tolist() == [[1, 0], [1, 32]]
    with pytest.raises(ValueError):
        tbs.pack_bits(torch.ones((2, 33), dtype=torch.int32))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,nn", [(70, 131), (64, 1000), (33, 5)])
def test_prepack_bit_exact(bits, k, nn):
    w = _x((k, nn), seed=k + bits)
    jp = jpk.prepack(jnp.asarray(w), bits)
    tp = tpk.prepack(t(w), bits)
    assert tp.bits == bits and tp.shape == (k, nn)
    assert_bits_equal(tp.codes32, jp.codes)
    assert_bits_equal(tp.planes, jp.planes)
    assert_bits_equal(tp.col_sums, jp.col_sums)
    assert_bits_equal(tp.wq.scale, jp.wq.scale)
    assert_bits_equal(tp.wq.qmin, jp.wq.qmin)
    assert_bits_equal(tp.to_float(), jp.to_float())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(3, 3, 5, 13), (7, 7, 3, 64),
                                   (1, 1, 64, 17), (3, 3, 40, 131)])
def test_prepack_conv_bit_exact(bits, shape):
    """Both conv layouts, including the (KH, bits, O, KW, CW) fused planes
    whose transpose order only an exact plane test can check."""
    w = _x(shape, seed=sum(shape) + bits)
    jp = jpk.prepack_conv(jnp.asarray(w), bits)
    tp = tpk.prepack_conv(t(w), bits)
    kh, kw, c, o = shape
    assert tp.kernel_shape == jp.kernel_shape == shape
    assert tuple(tp.fused_planes.shape) == (kh, bits, o, kw, (c + 31) // 32)
    assert_bits_equal(tp.fused_planes, jp.fused_planes)
    assert_bits_equal(tp.mat.codes32, jp.mat.codes)
    assert_bits_equal(tp.mat.planes, jp.mat.planes)
    assert_bits_equal(tp.mat.col_sums, jp.mat.col_sums)
    assert_bits_equal(tp.to_float(), jp.to_float())


def test_packed_weight_to_device_keeps_bits():
    tp = tpk.prepack_conv(t(_x((3, 3, 8, 4))), 4)
    moved = tp.to("cpu")
    assert moved.kernel_shape == tp.kernel_shape and moved.bits == 4
    assert torch.equal(moved.fused_planes, tp.fused_planes)
    assert torch.equal(moved.mat.planes, tp.mat.planes)
    assert torch.equal(moved.wq.scale, tp.wq.scale)
