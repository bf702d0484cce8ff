"""The port's training half against the JAX package on the CPU: fake
quantization with the straight-through estimator, ``calibrate_minmax``
per axis, the QAT branch of ``pim_linear``/``pim_conv2d``, ``loss_fn`` and
its gradients on five reduced archs (float32; QAT at one layer on two of
them, and the tensors QAT fake-quantizes on all five), remat,
the chunked loss, AdamW, the data pipeline, the train step with and
without accumulation, a restart from a checkpoint, and the launcher.

Inputs come from numpy seeds and go to both packages; weights are the JAX
package's init carried across (``convert.params_from_jax``), optimizer
states ``convert.opt_state_from_jax``. The JAX references are jitted.
"""
import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.core import pim_layers as jpl
from repro.core.packed import prepack as jprepack
from repro.core.quantize import calibrate_minmax as jcalibrate
from repro.core.quantize import fake_quant as jfake_quant
from repro.models.cnn import layers as jL
from repro.models.lm import model as jM
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import convert
from repro_torch.core import PIMQuantConfig
from repro_torch.core import pim_layers as tpl
from repro_torch.core.packed import prepack
from repro_torch.core.quantize import calibrate_minmax, fake_quant
from repro_torch.launch import train as tlaunch
from repro_torch.models.cnn import layers as tL
from repro_torch.models.lm import model as M
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training.fault_tolerance import FTConfig, run_resilient

from _torch_parity import (dense_cfgs, hybrid_cfgs, hybrid_params,
                           moe_cfgs, moe_params, stub_cfgs, stub_params, t)

_REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree, pre=""):
    """{path: leaf}, dict keys sorted (both packages' order)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], f"{pre}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat(x, f"{pre}/{i}").items()}
    return {pre: tree}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _assert_trees_close(got, want, tol):
    """Every leaf of ``got`` (the port) within ``tol`` relative L2 of the
    JAX tree ``want``."""
    gf, wf = _flat(got), _flat(jax.device_get(want))
    assert gf.keys() == wf.keys()
    worst = max(((_rel_l2(gf[k], wf[k]), k) for k in gf))
    assert worst[0] < tol, worst


def _jax_vjp(f, args, gy):
    """(f(*args), the gradients of ``args`` under cotangent ``gy``) in one
    jitted call of the JAX package (a single compile, where an eager
    ``jax.vjp`` compiles op by op). For the tests with a tolerance: the
    bit-for-bit ones run the reference eagerly, as jitting may reorder
    its float arithmetic."""
    def run(a, g):
        y, vjp = jax.vjp(f, *a)
        return y, vjp(g)
    return jax.jit(run)(tuple(jnp.asarray(a) for a in args), jnp.asarray(gy))


# -- fake quantization --------------------------------------------------------

def test_fake_quant_halves_the_gradient_at_the_bounds():
    """min/max calibration puts the extremes exactly on the clip bounds,
    where ``jnp.clip`` passes half the gradient (``torch.clamp`` would
    pass it all)."""
    x = np.array([-1, -0.3, 0.2, 0.7, 2], np.float32)
    want = jax.grad(lambda a: jfake_quant(a, 8).sum())(jnp.asarray(x))
    tx = t(x).requires_grad_(True)
    fake_quant(tx, 8).sum().backward()
    assert np.array_equal(tx.grad.numpy(), np.asarray(want))
    assert tx.grad.tolist() == [0.5, 1.0, 1.0, 1.0, 0.5]


@pytest.mark.parametrize("axis", [None, 1, (0, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 8])
def test_fake_quant_forward_and_ste_gradient_bit_for_bit(axis, dtype, bits):
    """Forward and the STE gradient equal JAX's bit for bit, per tensor and
    per axis (one int axis, and a tuple); bf16 stays bf16 (the shift runs
    in float32, as JAX promotes)."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((33, 17)).astype(np.float32) * 3
    g = rng.standard_normal((33, 17)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda a: jfake_quant(a, bits, axis=axis),
                     jnp.asarray(x).astype(jdt))
    (gx,) = vjp(jnp.asarray(g).astype(jdt))
    tx = t(x).to(tdt).requires_grad_(True)
    ty = fake_quant(tx, bits, axis=axis)
    ty.backward(t(g).to(tdt))
    assert ty.dtype == tdt and tx.grad.dtype == tdt
    assert np.array_equal(_np(ty), _np(y))
    assert np.array_equal(_np(tx.grad), _np(gx))


@pytest.mark.parametrize("axis", [0, 1, (0, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrate_minmax_per_axis_bit_for_bit(axis, dtype):
    x = np.random.default_rng(5).standard_normal((9, 31)).astype(np.float32)
    want = jcalibrate(jnp.asarray(x).astype(jnp.dtype(dtype)), 4,
                               axis=axis)
    got = calibrate_minmax(t(x).to(getattr(torch, dtype)), 4, axis=axis)
    for a, b in ((got.scale, want.scale), (got.qmin, want.qmin)):
        assert a.dtype == torch.float32
        assert np.array_equal(_np(a), _np(b))


# -- the QAT branch of the layers ---------------------------------------------

def _cfgs(bits):
    return (JPIMQuantConfig(bits, bits, backend="int-direct"),
            PIMQuantConfig(bits, bits, backend="int-direct"))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("packed", [False, True])
def test_pim_linear_train_matches_jax(bits, packed):
    """Forward within 1e-6 and the gradients of x, w and b within 1e-5
    (relative L2); a packed weight trains on its ``to_float()``."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 8, 48)).astype(np.float32)
    w = rng.standard_normal((48, 24)).astype(np.float32) * 0.2
    b = rng.standard_normal((24,)).astype(np.float32)
    gy = rng.standard_normal((3, 8, 24)).astype(np.float32)
    jc, tc = _cfgs(bits)
    if packed:
        jw = jprepack(jnp.asarray(w), bits)
        y, (gx, gb) = _jax_vjp(
            lambda a, c: jpl.pim_linear(a, jw, c, jc, train=True), (x, b), gy)
        tx, tb = (t(a).requires_grad_(True) for a in (x, b))
        ty = tpl.pim_linear(tx, prepack(t(w), bits), tb, tc, train=True)
        ty.backward(t(gy))
        pairs = ((tx.grad, gx), (tb.grad, gb))
    else:
        y, (gx, gw, gb) = _jax_vjp(
            lambda a, v, c: jpl.pim_linear(a, v, c, jc, train=True),
            (x, w, b), gy)
        tx, tw, tb = (t(a).requires_grad_(True) for a in (x, w, b))
        ty = tpl.pim_linear(tx, tw, tb, tc, train=True)
        ty.backward(t(gy))
        pairs = ((tx.grad, gx), (tw.grad, gw), (tb.grad, gb))
    assert _rel_l2(ty, y) < 1e-6
    for got, want in pairs:
        assert _rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 1)])
def test_pim_conv2d_train_matches_jax(stride, padding):
    rng = np.random.default_rng(stride + padding)
    x = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32) * 0.3
    b = rng.standard_normal((7,)).astype(np.float32)
    jc, tc = _cfgs(8)

    def jconv(a, v, c):
        return jpl.pim_conv2d(a, v, c, stride=stride, padding=padding,
                              cfg=jc, train=True)

    gy = rng.standard_normal(jax.eval_shape(jconv, x, w, b).shape).astype(
        np.float32)
    y, grads = _jax_vjp(jconv, (x, w, b), gy)
    tx, tw, tb = (t(a).requires_grad_(True) for a in (x, w, b))
    ty = tpl.pim_conv2d(tx, tw, tb, stride=stride, padding=padding, cfg=tc,
                        train=True)
    ty.backward(t(gy))
    assert _rel_l2(ty, y) < 1e-6
    for got, want in zip((tx.grad, tw.grad, tb.grad), grads):
        assert _rel_l2(got, want) < 1e-5


def test_cnn_blocks_train_match_jax():
    """``conv_block`` (conv, folded BN, ReLU) and ``fc_block`` with
    ``train=True``: forward within 1e-6, the gradients of the input and
    every weight within 1e-5 (relative L2)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 10, 10, 4)).astype(np.float32)
    conv = {"w": rng.standard_normal((3, 3, 4, 6)).astype(np.float32) * 0.3,
            "gamma": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "beta": rng.standard_normal(6).astype(np.float32) * 0.1,
            "mean": rng.standard_normal(6).astype(np.float32) * 0.1,
            "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    fc = {"w": rng.standard_normal((6 * 25, 5)).astype(np.float32) * 0.1,
          "b": rng.standard_normal(5).astype(np.float32)}
    jc, tc = _cfgs(8)

    def jnet(a, cw, fw):
        h = jL.conv_block(dict(conv, w=cw), a, stride=2, padding=1, cfg=jc,
                          train=True)
        return jL.fc_block(dict(fc, w=fw), h.reshape(2, -1), cfg=jc,
                           relu=False, train=True)

    y, vjp = jax.vjp(jnet, jnp.asarray(x), jnp.asarray(conv["w"]),
                     jnp.asarray(fc["w"]))
    gy = rng.standard_normal(y.shape).astype(np.float32)
    grads = vjp(jnp.asarray(gy))
    tx, tcw, tfw = (t(a).requires_grad_(True)
                    for a in (x, conv["w"], fc["w"]))
    h = tL.conv_block({**{k: t(v) for k, v in conv.items()}, "w": tcw}, tx,
                      stride=2, padding=1, cfg=tc, train=True)
    ty = tL.fc_block({"w": tfw, "b": t(fc["b"])}, h.reshape(2, -1), cfg=tc,
                     relu=False, train=True)
    ty.backward(t(gy))
    assert _rel_l2(ty, y) < 1e-6
    for got, want in zip((tx.grad, tcw.grad, tfw.grad), grads):
        assert _rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("name", ["alexnet", "resnet50", "vgg19"])
def test_cnn_apply_threads_train(name, monkeypatch):
    """Each CNN's ``apply(train=True)`` runs QAT through every layer: no
    bit-serial product (``pim_conv2d`` and ``pim_linear`` are float
    matmuls), finite logits, and a nonzero gradient on every weight."""
    from repro_torch.models.cnn import alexnet, resnet, vgg

    mod, image = {"alexnet": (alexnet, 64), "resnet50": (resnet, 32),
                  "vgg19": (vgg, 32)}[name]
    params = mod.init(torch.Generator().manual_seed(0), num_classes=10,
                      image=image)
    x = torch.randn((1, image, image, 3), generator=torch.Generator(
        ).manual_seed(1))
    ws = {k: v for k, v in _flat(params).items() if k.endswith("/w")}
    for w in ws.values():
        w.requires_grad_(True)
    _, tc = _cfgs(8)

    def refuse(*a, **k):
        raise AssertionError("a bit-serial product ran in training")

    for fn in ("quantized_matmul", "int_matmul_prepacked"):
        monkeypatch.setattr(tpl, fn, refuse)
    logits = mod.apply(params, x, cfg=tc, train=True)
    assert logits.shape == (1, 10) and torch.isfinite(logits).all()
    logits.square().sum().backward()
    for k, w in ws.items():
        assert w.grad is not None and w.grad.abs().sum() > 0, k


# -- loss_fn and its gradients ------------------------------------------------

_ARCHS = {
    # arch: (configs of both packages at n layers, params of both)
    "llama3.2-3b": (lambda n, **kw: dense_cfgs("llama3.2-3b", n_layers=n,
                                               **kw), moe_params),
    "phi3.5-moe-42b-a6.6b": (lambda n, **kw: moe_cfgs(n_layers=n, **kw),
                             moe_params),
    "recurrentgemma-9b": (lambda n, **kw: hybrid_cfgs(n_layers=n, **kw),
                          hybrid_params),
    "rwkv6-3b": (lambda n, **kw: dense_cfgs("rwkv6-3b", n_layers=n, **kw),
                 moe_params),
    "llama-3.2-vision-90b": (
        lambda n, **kw: stub_cfgs("llama-3.2-vision-90b", n_layers=n,
                                  cross_attn_every=1, **kw), stub_params),
}
# Layers of the float32 runs: recurrentgemma-9b's 3 are its unit (rglru,
# rglru, local_attn), llama-3.2-vision-90b's 2 an attn and a cross_attn.
_LAYERS = {"recurrentgemma-9b": 3}


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n):
    """The JAX package's tree (numpy) of ``arch`` reduced at ``n`` layers,
    made once for the module (its init compiles once)."""
    make_cfgs, make_params = _ARCHS[arch]
    return make_params(make_cfgs(n)[0])[0]


def _params(arch, n):
    """(the JAX tree of ``_jax_params``, a fresh port copy of it)."""
    jp = _jax_params(arch, n)
    return jp, convert.params_from_jax(jp)


def _batch(jcfg, seed=0, b=2, s=32) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.n_image_tokens:
        batch["image_embeds"] = rng.standard_normal(
            (b, jcfg.n_image_tokens, jcfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _loss_and_grads(arch, qat):
    """(JAX loss, JAX grads, port loss, port grads) of ``arch`` reduced,
    float32 at its ``_LAYERS``, or QAT at one layer. Kept for the module,
    so each JAX reference compiles once."""
    return _compute_loss_and_grads(arch, qat)


def _compute_loss_and_grads(arch, qat):
    n = 1 if qat else _LAYERS.get(arch, 2)
    jc, tc = _ARCHS[arch][0](n)
    if qat:
        jpim, tpim = _cfgs(8)
        jc, tc = (dataclasses.replace(jc, pim=jpim),
                  dataclasses.replace(tc, pim=tpim))
    jp, tp = _params(arch, n)
    batch = _batch(jc)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, bt: jM.loss_fn(p, jc, bt, train=True)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = ttl.value_and_grad(ttl.make_loss_fn(tc), tp,
                                {k: t(v) for k, v in batch.items()})
    return float(jl), jg, float(tl), tg


# QAT tolerances, relative L2: 1.5x the largest gap measured against the
# JAX reference on the CPU (gradients 4.28e-4, recurrentgemma-9b's
# rglru/w_a; llama3.2-3b 1.43e-4; logits 1.40e-3), at 2 and 6 threads
# alike. Both heads run the inference pipeline under QAT, so a code
# flipped by float jitter moves the loss and the head's min/max gradient
# but reaches no straight-through product.
_QAT_GRAD, _QAT_LOGITS = 6.5e-4, 2.1e-3
# The numeric QAT runs: the arch trained on the card and the hybrid (the
# largest gap). Which tensors every arch fake-quantizes is held against
# the reference by test_qat_fake_quantizes_the_references_tensors.
_QAT_ARCHS = ("llama3.2-3b", "recurrentgemma-9b")


@pytest.mark.parametrize("arch,qat", [(a, False) for a in _ARCHS] + [
    (a, True) for a in _QAT_ARCHS], ids=lambda v: {
        False: "float32", True: "qat"}.get(v, v))
def test_loss_fn_and_grads_match_jax(arch, qat):
    """float32: loss within 1e-5 relative, every gradient leaf within 1e-4
    relative L2 (the MoE aux loss, the RG-LRU scan, rwkv6's chunked WKV
    through the plain backward of its Function, the cross gate all enter).
    QAT (<8:8> fake quantization of every projection, the head on the
    inference pipeline in both packages) at one layer: loss 1e-4,
    gradients ``_QAT_GRAD`` (the <8:8> path is chaotic: float jitter
    flips codes)."""
    jl, jg, tl, tg = _loss_and_grads(arch, qat)
    assert np.isfinite(tl)
    assert abs(tl - jl) <= (1e-4 if qat else 1e-5) * abs(jl)
    _assert_trees_close(tg, jg, _QAT_GRAD if qat else 1e-4)


def _fake_quant_calls(monkeypatch, mod, run) -> list:
    """Sorted (shape, bits) of every ``fake_quant`` that ``mod``'s
    ``pim_linear`` makes while ``run()`` runs."""
    calls, real = [], mod.fake_quant

    def spy(x, bits, axis=None):
        calls.append((tuple(x.shape), bits))
        return real(x, bits, axis=axis)

    monkeypatch.setattr(mod, "fake_quant", spy)
    run()
    monkeypatch.setattr(mod, "fake_quant", real)
    return sorted(calls)


@pytest.mark.parametrize("arch", list(_ARCHS))
def test_qat_fake_quantizes_the_references_tensors(arch, monkeypatch):
    """One unit of each arch under <8:8> QAT: the port's ``loss_fn``
    fake-quantizes every tensor the JAX package's ``loss_fn(train=True)``
    does (shape and bits; the JAX side traced with ``eval_shape``) and
    no other: the head runs the inference pipeline in both."""
    n = _LAYERS.get(arch, 1 if arch != "llama-3.2-vision-90b" else 2)
    jc, tc = _ARCHS[arch][0](n)
    jpim, tpim = _cfgs(8)
    jc, tc = (dataclasses.replace(jc, pim=jpim),
              dataclasses.replace(tc, pim=tpim))
    jp, tp = _params(arch, n)
    batch = _batch(jc)
    want = _fake_quant_calls(monkeypatch, jpl, lambda: jax.eval_shape(
        lambda p, bt: jM.loss_fn(p, jc, bt, train=True), jp,
        {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = _fake_quant_calls(monkeypatch, tpl, lambda: M.loss_fn(
            tp, tc, {k: t(v) for k, v in batch.items()}, train=True))
    assert len(want) >= 2 * n
    assert got == want


@pytest.mark.parametrize("arch", ["llama3.2-3b", "phi3.5-moe-42b-a6.6b",
                                  "recurrentgemma-9b"])
def test_remat_grads_equal_without_remat(arch):
    """Each rep of the unit under ``torch.utils.checkpoint`` ("block" and
    "full") gives the loss and every gradient of the plain run bit for
    bit; the MoE aux is counted once, not again in the recompute."""
    make_cfgs = _ARCHS[arch][0]
    n = _LAYERS.get(arch, 2)
    jc, _ = make_cfgs(n)
    _, tp = _params(arch, n)
    batch = {k: t(v) for k, v in _batch(jc).items()}
    runs = {}
    for remat in ("none", "block", "full"):
        _, tc = make_cfgs(n, remat=remat)
        runs[remat] = ttl.value_and_grad(ttl.make_loss_fn(tc), tp, batch)
    for remat in ("block", "full"):
        assert torch.equal(runs[remat][0], runs["none"][0])
        got, want = _flat(runs[remat][1]), _flat(runs["none"][1])
        for k in want:
            assert torch.equal(got[k], want[k]), (remat, k)


def test_chunked_loss_matches_unchunked_and_jax():
    """``loss_chunk`` 8 over 32 positions: the port's chunked loss and
    gradients against its unchunked ones (1e-6) and against JAX's
    chunked run (1e-5, 1e-4)."""
    jc, tc = dense_cfgs("llama3.2-3b", n_layers=2, loss_chunk=8)
    _, tc0 = dense_cfgs("llama3.2-3b", n_layers=2)
    jp, tp = _params("llama3.2-3b", 2)
    batch = _batch(jc, seed=3)
    tb = {k: t(v) for k, v in batch.items()}
    l8, g8 = ttl.value_and_grad(ttl.make_loss_fn(tc), tp, tb)
    l0, g0 = ttl.value_and_grad(ttl.make_loss_fn(tc0), tp, tb)
    assert abs(float(l8) - float(l0)) <= 1e-6 * abs(float(l0))
    for k, v in _flat(g0).items():
        assert _rel_l2(_flat(g8)[k], v) < 1e-6, k
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, bt: jM.loss_fn(p, jc, bt, train=True)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(l8) - float(jl)) <= 1e-5 * abs(float(jl))
    _assert_trees_close(g8, jg, 1e-4)


def _head_vjp_inputs(seed=5):
    """(JAX cfg, port cfg, params, head input x, cotangent) of reduced
    llama3.2-3b (tied head) at <8:8>, from numpy seeds."""
    jc, tc = dense_cfgs("llama3.2-3b", n_layers=1)
    jpim, tpim = _cfgs(8)
    jc, tc = (dataclasses.replace(jc, pim=jpim),
              dataclasses.replace(tc, pim=tpim))
    jp, _ = _params("llama3.2-3b", 1)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, jc.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, 32, jc.vocab)).astype(np.float32)
    return jc, tc, jp["embed"], x, gy


def test_reference_qat_head_takes_no_straight_through_gradient():
    """Under QAT the port's head, like the JAX package's, runs the
    inference pipeline: its rounding passes no straight-through gradient,
    so the gradient reaches its input and its (tied) weight only through
    the calibration's min and max. Each gradient is nonzero at exactly the
    input's and the weight's argmin and argmax, the reference's positions,
    and its values are the reference's within 6e-5 relative L2, the logits
    within 4.7e-5: 1.5x the gaps measured (3.96e-5, 3.10e-5; the affine
    correction's float32 terms summed in another order than the jitted
    reference's)."""
    jc, tc, emb, x, gy = _head_vjp_inputs()
    (want, (jgx, jge)) = _jax_vjp(
        lambda xx, e: jM.lm_head({"embed": e}, jc, xx), (x, emb), gy)
    tx, te = (t(a).requires_grad_() for a in (x, emb))
    got = M.lm_head({"embed": te}, tc, tx)
    gx, ge = torch.autograd.grad(got, (tx, te), t(gy))
    assert _rel_l2(got, want) < 4.7e-5
    for g, jg, a in ((gx, jgx, x), (ge, jge, emb)):
        g, jg = _np(g), _np(jg)
        nz = sorted(np.flatnonzero(g))
        assert nz == sorted({int(np.argmin(a)), int(np.argmax(a))})
        assert nz == sorted(np.flatnonzero(jg))
        assert _rel_l2(g, jg) < 6e-5


def test_forward_train_flag_matches_jax():
    """``forward(train=True)`` with QAT at one layer: the logits within
    ``_QAT_LOGITS`` relative L2 of the JAX package's (float jitter of ~1e-6
    flips a few <8:8> codes; the path's own spread, see ROADMAP.md "Known
    problems")."""
    jc, tc = dense_cfgs("llama3.2-3b", n_layers=1)
    jpim, tpim = _cfgs(8)
    jc, tc = (dataclasses.replace(jc, pim=jpim),
              dataclasses.replace(tc, pim=tpim))
    jp, tp = _params("llama3.2-3b", 1)
    toks = _batch(jc)["tokens"]
    want, _ = jax.jit(lambda p, x: jM.forward(p, jc, x, train=True))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = M.forward(tp, tc, t(toks), train=True)
        float_logits, _ = M.forward(tp, dataclasses.replace(tc, pim=None),
                                    t(toks))
    assert _rel_l2(got, want) < _QAT_LOGITS
    assert _rel_l2(got, float_logits) > 1e-4     # the QAT branch ran


# -- AdamW --------------------------------------------------------------------

_OCFG = dict(lr=1e-3, warmup_steps=10, total_steps=50)


@pytest.mark.parametrize("step", [0, 1, 10, 30, 50, 60])
def test_schedule_matches_jax(step):
    cfg, jcfg = topt.OptimizerConfig(**_OCFG), jopt.OptimizerConfig(**_OCFG)
    want = float(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32)))
    got = float(topt.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= 1e-6 * abs(want) + 1e-12


@functools.lru_cache(maxsize=None)
def _jax_update(keep_master):
    """The JAX package's ``apply_updates``, jitted once for the module."""
    jcfg = jopt.OptimizerConfig(**_OCFG, keep_master=keep_master)
    return jax.jit(lambda p, g, s: jopt.apply_updates(jcfg, p, g, s))


def _update_run(keep_master, scales, rtol):
    """AdamW steps over a reduced llama tree in both packages (bf16 params
    with float32 masters, or float32 params alone), each step's gradients
    numpy normals times its scale: m, v and masters (or float32 params)
    within ``rtol`` after each step; a bf16 param is its own master cast
    (a master one ulp off may round the other way, never further)."""
    jp = _jax_params("llama3.2-3b", 2)
    if keep_master:
        jp = jax.device_get(jM.cast_params(jp, jnp.bfloat16))
    tp = convert.params_from_jax(jp)
    kw = dict(_OCFG, keep_master=keep_master)
    jcfg, cfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jstate = jopt.init_opt_state(jcfg, jp)
    state = topt.init_opt_state(cfg, tp)
    for k, v in _flat(convert.opt_state_from_jax(jstate)).items():
        assert torch.equal(_flat(state)[k], v), k
    rng = np.random.default_rng(11)
    update = _jax_update(keep_master)
    paths = list(_flat(jp))
    for i, scale in enumerate(scales):
        noise = iter([rng.standard_normal(np.shape(_flat(jp)[k])) * scale
                      for k in paths])
        jg = jax.tree.map(lambda p: jnp.asarray(next(noise)).astype(p.dtype),
                          jp)
        tg = convert.params_from_jax(jax.device_get(jg))
        jp, jstate, jm = update(jp, jg, jstate)
        tp, state, m = topt.apply_updates(cfg, tp, tg, state)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-5 * float(jm["grad_norm"]))
        want_state = _flat(jax.device_get(jstate))
        for k, v in _flat(state).items():
            if k != "/step":
                np.testing.assert_allclose(_np(v), _np(want_state[k]),
                                           rtol=rtol, atol=1e-9, err_msg=k)
        masters = _flat(state["master"]) if keep_master else None
        for k, v in _flat(tp).items():
            if keep_master:
                assert str(v.dtype)[6:] == str(_flat(jp)[k].dtype)
                assert torch.equal(v, masters[k].to(v.dtype)), k
            else:
                np.testing.assert_allclose(_np(v), _np(_flat(jp)[k]),
                                           rtol=rtol, atol=1e-9, err_msg=k)
    return m


@pytest.mark.parametrize("keep_master", [True, False])
def test_apply_updates_three_steps_match_jax(keep_master):
    """Three unclipped steps (global norms below 1): rtol 1e-6."""
    m = _update_run(keep_master, (1e-4, 3e-4, 1e-4), 1e-6)
    assert float(m["grad_norm"]) < 1.0


@pytest.mark.parametrize("keep_master", [True, False])
def test_apply_updates_clips_like_jax(keep_master):
    """Clipped steps (global norms ~600): each package sums the 650 k
    squares in its own order, the norms agree within 1e-5 and so, through
    the clip scale, do m, v and the masters."""
    m = _update_run(keep_master, (1.0, 3.0), 1e-5)
    assert float(m["grad_norm"]) > 1.0


def test_decay_mask_follows_the_last_key():
    named = dict((f"{i}:{n}", n) for i, (n, _) in enumerate(topt._named(
        {"scan": [{"norm1": {"scale": 0}, "attn": {"wq": 0, "bq": 0}}],
         "embed": 0})))
    decays = {n: topt._decay_mask(n) for n in named.values()}
    assert decays == {"scale": False, "bq": False, "wq": True,
                      "embed": True}


# -- the data pipeline --------------------------------------------------------

def test_synthetic_batches_equal_jax():
    kw = dict(vocab=512, seq_len=32, global_batch=4, seed=3)
    js = jdata.make_source(jdata.DataConfig(**kw))
    ts = tdata.make_source(tdata.DataConfig(**kw))
    assert isinstance(ts, tdata.SyntheticLM)
    for step in (0, 1, 7):
        want, got = js.batch(step), ts.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])
        for host in (0, 1):
            ws, gs = js.host_slice(step, host, 2), ts.host_slice(step, host, 2)
            for k in ("tokens", "labels"):
                assert np.array_equal(gs[k], ws[k])


def test_memmap_batches_equal_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1 << 20, 5000).astype(
        np.int32).tofile(path)
    kw = dict(vocab=1000, seq_len=16, global_batch=3, seed=2,
              source="memmap", path=str(path))
    js = jdata.make_source(jdata.DataConfig(**kw))
    ts = tdata.make_source(tdata.DataConfig(**kw))
    assert isinstance(ts, tdata.MemmapTokens)
    for step in (0, 5):
        for k in ("tokens", "labels"):
            assert np.array_equal(ts.batch(step)[k], js.batch(step)[k])
            assert np.array_equal(ts.host_slice(step, 2, 3)[k],
                                  js.host_slice(step, 2, 3)[k])
    short = tmp_path / "short.bin"
    np.zeros(10, np.int32).tofile(short)
    with pytest.raises(ValueError, match="shorter than one sequence"):
        tdata.MemmapTokens(tdata.DataConfig(**dict(kw, path=str(short))))
    with pytest.raises(ValueError):
        tdata.make_source(tdata.DataConfig(vocab=8, seq_len=4,
                                           global_batch=1, source="parquet"))


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_three_steps_match_jax(accum):
    """Three steps of ``make_train_step`` on reduced llama3.2-3b (float32,
    2 layers, batches of 4 x 32 from ``SyntheticLM``), from one state in
    both packages: losses within 1e-5, every param within 1e-5 relative
    L2."""
    jc, tc = dense_cfgs("llama3.2-3b", n_layers=2)
    jp, tp = _params("llama3.2-3b", 2)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jcfg, cfg = jopt.OptimizerConfig(**ocfg), topt.OptimizerConfig(**ocfg)
    jstate = jopt.init_opt_state(jcfg, jp)
    state = convert.opt_state_from_jax(jax.device_get(jstate))
    jstep = jax.jit(jtl.make_train_step(jc, jcfg, accum=accum))
    step = ttl.make_train_step(tc, cfg, accum=accum)
    source = tdata.SyntheticLM(tdata.DataConfig(vocab=jc.vocab, seq_len=32,
                                                global_batch=4))
    for i in range(3):
        batch = source.batch(i)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        tp, state, m = step(tp, state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"]))
        _assert_trees_close(tp, jp, 1e-5)


def test_accumulation_sums_bf16_gradients_in_float32(monkeypatch):
    """With ``accum`` > 1 the optimizer receives float32 gradients (summed
    in float32 buffers, as the reference's float32 carry); with one batch
    it receives the params' own bf16 gradients, as JAX's grad gives."""
    _, tc = dense_cfgs("llama3.2-3b", n_layers=1)
    tc = dataclasses.replace(tc, dtype="bfloat16")
    tp = M.cast_params(M.init(tc, torch.Generator().manual_seed(0),
                              device="cpu"), torch.bfloat16)
    seen = []
    real = ttl.apply_updates

    def spy(cfg, params, grads, state):
        seen.append({g.dtype for g in topt.leaves(grads)})
        return real(cfg, params, grads, state)

    monkeypatch.setattr(ttl, "apply_updates", spy)
    cfg = topt.OptimizerConfig()
    batch = tdata.SyntheticLM(tdata.DataConfig(
        vocab=tc.vocab, seq_len=16, global_batch=4)).batch(0)
    for accum in (1, 2):
        ttl.make_train_step(tc, cfg, accum=accum)(
            tp, topt.init_opt_state(cfg, tp), batch)
    assert seen[0] == {torch.bfloat16, torch.float32}   # norm scales f32
    assert seen[1] == {torch.float32}


def test_run_resilient_restart_equals_uninterrupted_run(tmp_path):
    """A step that fails once rolls back to the last checkpoint and the run
    ends with params and optimizer state bit for bit those of a run that
    never failed (the batches are keyed by step)."""
    def run(ckpt, injector=None):
        _, tc = dense_cfgs("llama3.2-3b", n_layers=1)
        tp = M.init(tc, torch.Generator().manual_seed(0), device="cpu")
        cfg = topt.OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=6)
        source = tdata.SyntheticLM(tdata.DataConfig(
            vocab=tc.vocab, seq_len=16, global_batch=2))
        return run_resilient(ttl.make_train_step(tc, cfg), tp,
                             topt.init_opt_state(cfg, tp), source, 6,
                             FTConfig(ckpt_dir=str(ckpt), ckpt_every=2,
                                      backoff_s=0.0),
                             fail_injector=injector)

    fired = []

    def fail_at_4(step):
        if step == 4 and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    p0, s0, stats0 = run(tmp_path / "clean")
    p1, s1, stats1 = run(tmp_path / "restart", fail_at_4)
    assert fired == [4] and stats1["restarts"] == 1
    assert stats1["steps_run"] == stats0["steps_run"] + 1   # step 3 again
    for a, b in ((p0, p1), (s0, s1)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k


# -- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("pim", [False, True], ids=["bf16", "qat"])
def test_launcher_trains_reduced_on_cpu_and_loss_falls(tmp_path, capsys, pim):
    argv = ["--arch", "llama3.2-3b", "--reduced", "--steps", "12",
            "--batch", "4", "--seq", "32", "--lr", "3e-3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    history = tlaunch.main(argv + (["--pim"] if pim else []))
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b reduced=True device=cpu" in out
    assert "'restarts': 0" in out and "tok/s" in out
    assert len(history) == 12
    losses = [loss for _, loss in history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_launcher_build_keeps_the_arch_with_float32_masters():
    """``build`` keeps the arch's config; the params are the arch's dtype
    with float32 masters, and ``pim`` sets <8:8> int-direct QAT."""
    cfg, params, state, _, source, _ = tlaunch.build(
        "llama3.2-3b", True, 2, 32, 4, 1e-3, 1, False, pim=True,
        device="cpu")
    arch = tlaunch.get_config("llama3.2-3b").model.reduced()
    assert dataclasses.replace(cfg, pim=None) == arch
    assert (cfg.pim.w_bits, cfg.pim.a_bits, cfg.pim.backend) == (
        8, 8, "int-direct")
    assert params["scan"][0]["attn"]["wq"].shape[0] == arch.n_layers
    assert params["scan"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert state["master"]["embed"].dtype == torch.float32
    assert source.batch(0)["tokens"].shape == (2, 32)


def test_launcher_refuses_the_production_mesh():
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        tlaunch.build("llama3.2-3b", True, 2, 8, 1, 1e-3, 1, True,
                      device="cpu")


# -- import hygiene of the new modules ----------------------------------------

_NEW = ("training/optimizer.py", "training/data.py", "training/train_loop.py",
        "launch/train.py")


def test_training_modules_import_no_jax_or_repro():
    """The AST of each training module and of the example twin names no
    jax, jaxlib or repro import. (Importing them loads none of those
    modules: test_torch_vision.py's
    ``test_importing_every_port_module_loads_no_jax_or_repro`` imports
    every module of the port and the examples in one fresh process.)"""
    src = _REPO / "src" / "repro_torch"
    paths = [src / rel for rel in _NEW] + [
        _REPO / "examples" / "torch_train_lm.py"]
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    path, name)

