"""Port parity, layers: ``pim_linear``, ``pim_conv2d`` (both lowerings), the
fused-conv dispatch heuristic and one ResNet bottleneck block of
``repro_torch`` against the JAX package on the same numpy inputs and
weights. The port runs on the CPU, i.e. through the kernels' plain
versions; the JAX side runs its Pallas kernels in interpret mode.

Float outputs are compared at rtol=1e-5, atol=1e-5*max|ref|: both sides
apply the same float32 operations in the same order, but XLA may fuse a
multiply and an add into one FMA. Calibration is a min/max and exact, so
the integer path (codes, P) is compared exactly in the kernel tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_close, t

from repro.core import pim_layers as jpl
from repro.models.cnn import layers as jL
from repro.models.cnn import resnet as jresnet
from repro_torch import convert
from repro_torch.core import pim_layers as tpl
from repro_torch.models.cnn import layers as tL
from repro_torch.models.cnn import resnet as tresnet


def _x(shape, seed, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            + offset).astype(np.float32)


def _cfgs(bits, jax_backend="pallas"):
    return (jpl.PIMQuantConfig(bits, bits, backend=jax_backend),
            tpl.PIMQuantConfig(bits, bits, backend="cuda"))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("prepacked", [False, True])
def test_pim_linear_quantized(bits, prepacked):
    """Leading dims flatten into one calibration; N=131 is ragged."""
    x, w, b = _x((2, 3, 70), 0, 1.0), _x((70, 131), 1), _x((131,), 2)
    jcfg, tcfg = _cfgs(bits)
    jw = jpl.prepack_linear(jnp.asarray(w), jcfg) if prepacked \
        else jnp.asarray(w)
    tw = tpl.prepack_linear(t(w), tcfg) if prepacked else t(w)
    got = tpl.pim_linear(t(x), tw, t(b), cfg=tcfg)
    want = jpl.pim_linear(jnp.asarray(x), jw, jnp.asarray(b), cfg=jcfg)
    assert got.shape == (2, 3, 131)
    assert_close(got, want)


def test_pim_linear_float_and_disabled():
    x, w = _x((4, 64), 3), _x((64, 10), 4)
    want = jpl.pim_linear(jnp.asarray(x), jnp.asarray(w))
    assert_close(tpl.pim_linear(t(x), t(w)), want)
    off = tpl.PIMQuantConfig(8, 8, enabled=False)
    assert_close(tpl.pim_linear(t(x), t(w), cfg=off), want)


@pytest.mark.parametrize("mode", ["fused", "im2col"])
@pytest.mark.parametrize("shape,o,ks,stride,pad,bits", [
    ((2, 9, 9, 33), 16, 3, 1, 1, 8),
    ((2, 9, 13, 5), 8, 3, 2, 1, 4),      # odd width, stride 2
    ((1, 6, 6, 8), 131, 3, 1, 1, 2),     # prime O
    ((1, 9, 8, 3), 16, 7, 2, 3, 8),      # the stem: C=3, 7x7/2, padding 3
    ((2, 7, 7, 16), 12, 1, 2, 0, 8),     # 1x1 projection, stride 2
])
def test_pim_conv2d_quantized(mode, shape, o, ks, stride, pad, bits):
    """Calibration on the real input, zero-code padding and the per-patch
    border correction (Sw, K) through both lowerings; the activation is
    post-ReLU-like (strictly positive), where padding matters most."""
    x = np.abs(_x(shape, sum(shape), 0.5))
    w = _x((ks, ks, shape[-1], o), o) * 0.2
    jcfg, tcfg = _cfgs(bits, "pallas" if mode == "fused" else "int-direct")
    got = tpl.pim_conv2d(t(x), tpl.prepack_conv2d(t(w), tcfg), stride=stride,
                         padding=pad, cfg=tcfg, conv_mode=mode)
    want = jpl.pim_conv2d(jnp.asarray(x),
                          jpl.prepack_conv2d(jnp.asarray(w), jcfg),
                          stride=stride, padding=pad, cfg=jcfg,
                          conv_mode=mode)
    assert_close(got, want)


def test_pim_conv2d_float_weights_bias_and_float_path():
    x, w, b = _x((2, 8, 8, 6), 5), _x((3, 3, 6, 10), 6), _x((10,), 7)
    jcfg, tcfg = _cfgs(8, "int-direct")
    for cfg_pair in ((jcfg, tcfg), (None, None)):
        got = tpl.pim_conv2d(t(x), t(w), t(b), stride=2, padding=1,
                             cfg=cfg_pair[1])
        want = jpl.pim_conv2d(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), stride=2, padding=1,
                              cfg=cfg_pair[0])
        assert_close(got, want)
    with pytest.raises(ValueError, match="conv_mode"):
        tpl.pim_conv2d(t(x), t(w), cfg=tcfg, conv_mode="winograd")


def test_fuse_conv_heuristic_fires_where_pallas_fires():
    """"cuda" fires exactly where the JAX package fires for "pallas"; the
    ResNet-50 cases at 224 px named in the port's notes are among them."""
    shapes = [(n, oh, oh, k, k, c) for n in (1, 4, 8) for oh in (7, 14, 28,
              56, 112) for k in (1, 3, 7) for c in (3, 64, 128, 256, 512)]
    for s in shapes:
        assert tpl.fuse_conv_heuristic(*s, "cuda") == \
            jpl.fuse_conv_heuristic(*s, "pallas")
        assert not tpl.fuse_conv_heuristic(*s, "int-direct")
    assert tpl.fuse_conv_heuristic(8, 7, 7, 3, 3, 512, "cuda")      # s3, b=8
    assert not tpl.fuse_conv_heuristic(4, 7, 7, 3, 3, 512, "cuda")  # s3, b=4
    assert tpl.fuse_conv_heuristic(1, 56, 56, 3, 3, 64, "cuda")     # s0, b=1
    assert not tpl.fuse_conv_heuristic(1, 28, 28, 3, 3, 128, "cuda")


@pytest.mark.parametrize("quantized", [False, True])
def test_resnet_bottleneck_with_projection_stride2(quantized):
    """One bottleneck block (c1, c2 3x3/2, c3, 1x1/2 projection) with the
    JAX package's own weights carried across by ``convert``."""
    key = jax.random.PRNGKey(0)
    cin, mid = 16, 8
    jp = {"c1": jL.init_conv(jax.random.fold_in(key, 0), 1, cin, mid),
          "c2": jL.init_conv(jax.random.fold_in(key, 1), 3, mid, mid),
          "c3": jL.init_conv(jax.random.fold_in(key, 2), 1, mid, 4 * mid),
          "proj": jL.init_conv(jax.random.fold_in(key, 3), 1, cin, 4 * mid)}
    tp = convert.params_from_jax(jax.device_get(jp))
    x = np.abs(_x((2, 9, 9, cin), 8))
    jcfg, tcfg = _cfgs(8) if quantized else (None, None)
    if quantized:
        jp, tp = jL.prepack_params(jp, jcfg), tL.prepack_params(tp, tcfg)
    got = tresnet._bottleneck(tp, t(x), 2, tcfg)
    want = jresnet._bottleneck(jp, jnp.asarray(x), 2, jcfg, False)
    assert got.shape == (2, 5, 5, 4 * mid)
    assert_close(got, want)
