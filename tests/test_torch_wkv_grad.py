"""The gradient of the chunked RWKV-6 WKV on the CPU: the plain backward
(``rwkv_chunk.wkv_chunked_bwd_plain``, what the backward kernel's wrapper
runs on a CPU tensor) against ``torch.autograd`` of the plain chunked
forward and of the sequential scan, a float64 ``gradcheck`` of the
``WKVChunked`` Function, its ``None`` handling, and the model's
``_chunked_wkv`` gradients against ``jax.vjp`` of the JAX package's.

Inputs are drawn with numpy from a seed (the reference kernel test's
distributions) and given to both packages.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import rwkv6 as jRW
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_chunk as K
from repro_torch.models.lm import rwkv6 as RW

from _torch_parity import t


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(bh, s, d, seed, clamp=False):
    """(r, k, v, lw, u, s0, dy, ds_final) float64 numpy. ``clamp``: log
    decays drawn so that about half sit at the -5 clamp (the algebra's
    largest exponents, e^{5L} within a chunk)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, s, d)) * 0.5 for _ in range(3))
    shift = 1.5 if clamp else -2.0
    lw = np.maximum(-np.exp(rng.standard_normal((bh, s, d)) + shift), -5.0)
    u = rng.standard_normal((bh, d)) * 0.2
    s0 = rng.standard_normal((bh, d, d)) * 0.1
    dy = rng.standard_normal((bh, s, d))
    ds_final = rng.standard_normal((bh, d, d))
    return r, k, v, lw, u, s0, dy, ds_final


def _rel_l2(got, want) -> float:
    got, want = (x.detach().to(torch.float64) for x in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).norm() / (want.norm() + 1e-300))


def _autograd(fn, args, dy, ds_final):
    """Gradients of (r, k, v, lw, u, s0) under ``fn`` by torch.autograd."""
    leaves = [x.clone().requires_grad_() for x in args]
    y, s_fin = fn(*leaves)
    return torch.autograd.grad((y, s_fin), leaves, (dy, ds_final))


# (D, chunk) over D in {8, 64} and every chunk the kernel takes; S = 64
# holds two chunks of 32, BH = 3 heads.
_SHAPES = list(itertools.product((8, 64), (8, 16, 32)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d,chunk", _SHAPES)
def test_plain_backward_matches_autograd(d, chunk, dtype):
    """Every gradient (dr, dk, dv, dlw, du, ds0), with nonzero s0 and
    dS_final, against torch.autograd in float64 of the plain chunked
    forward and of the sequential scan: float64 within 1e-12 relative L2
    (measured below 1e-15), float32 within 1e-5 (measured ~3e-7)."""
    a = _inputs(3, 64, d, seed=d * 100 + chunk)
    a64 = [torch.from_numpy(x) for x in a]
    got = K.wkv_chunked_bwd_plain(
        *(x.to(getattr(torch, dtype)) for x in a64), chunk)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for fn in (lambda *x: K.wkv_chunked_plain(*x, chunk), K.wkv_chunked_ref):
        want = _autograd(fn, a64[:6], *a64[6:])
        for name, g, w in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got,
                              want):
            assert g.dtype == getattr(torch, dtype)
            assert _rel_l2(g, w) < tol, (name, _rel_l2(g, w))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_backward_at_the_decay_clamp(dtype):
    """rwkv6-3b's head dim and chunk (D = 64, L = 16) over 256 tokens with
    about half the log decays at the -5 clamp (k e^{-P} reaches e^80):
    within 1e-12 (float64) and 1e-5 (float32; dlw the worst leaf, ~1.7e-6
    measured, as float32 autograd's own ~1.9e-6) of float64 autograd of
    the plain forward."""
    a64 = [torch.from_numpy(x) for x in _inputs(4, 256, 64, seed=3,
                                                 clamp=True)]
    assert float((a64[3] == -5.0).double().mean()) > 0.4
    got = K.wkv_chunked_bwd_plain(
        *(x.to(getattr(torch, dtype)) for x in a64), 16)
    want = _autograd(lambda *x: K.wkv_chunked_plain(*x, 16), a64[:6],
                     *a64[6:])
    tol = 1e-12 if dtype == "float64" else 1e-5
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got, want):
        assert _rel_l2(g, w) < tol, (name, _rel_l2(g, w))


def test_function_passes_gradcheck_in_float64():
    """``WKVChunked`` (the plain versions in float64 on the CPU) under
    ``torch.autograd.gradcheck`` at a tiny shape, both outputs used."""
    a = [torch.from_numpy(x).requires_grad_()
         for x in _inputs(2, 16, 8, seed=11)[:6]]
    assert torch.autograd.gradcheck(
        lambda *x: K.WKVChunked.apply(*x, 8), a, eps=1e-6, atol=1e-7,
        rtol=1e-5)


def test_function_handles_missing_gradients_and_launches_nothing_here():
    """An unused output's gradient is taken as zero (y alone, S_final
    alone), an input that needs no gradient gets None, and on CPU tensors
    neither the forward nor the backward kernel is counted."""
    a = [torch.from_numpy(x).float() for x in _inputs(2, 32, 8, seed=5)]
    r, k, v, lw, u, s0, dy, dsf = a
    zero_y, zero_s = torch.zeros_like(dy), torch.zeros_like(dsf)
    before = ops.launch_counts()
    for use_y, use_s in ((True, False), (False, True)):
        leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u, s0)]
        y, s_fin = ops.wkv_chunked(*leaves, chunk=8)
        outs, cots = zip(*[(o, c) for o, c, use in (
            (y, dy, use_y), (s_fin, dsf, use_s)) if use])
        got = torch.autograd.grad(outs, leaves, cots)
        want = K.wkv_chunked_bwd_plain(r, k, v, lw, u, s0,
                                       dy if use_y else zero_y,
                                       dsf if use_s else zero_s, 8)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    leaf = r.clone().requires_grad_()
    y, _ = K.WKVChunked.apply(leaf, k, v, lw, u, s0, 8)
    grads = y.grad_fn.apply(dy, None)
    assert grads[0] is not None and all(g is None for g in grads[1:])
    assert ops.launch_counts() == before


def test_backward_wrapper_checks_its_operands():
    a = [torch.from_numpy(x).float() for x in _inputs(2, 32, 8, seed=6)]
    r, k, v, lw, u, s0, dy, dsf = a
    with pytest.raises(ValueError, match="dy"):
        ops.wkv_chunked_bwd(r, k, v, lw, u, s0, dy[:, :16], dsf, chunk=8)
    with pytest.raises(ValueError, match="ds_final"):
        ops.wkv_chunked_bwd(r, k, v, lw, u, s0, dy, dsf[:, :4], chunk=8)
    with pytest.raises(ValueError, match="float32"):
        ops.wkv_chunked_bwd(r.double(), k, v, lw, u, s0, dy, dsf, chunk=8)
    m = [x.to("meta") for x in a]
    with pytest.raises(ValueError, match="device"):
        ops.wkv_chunked_bwd(*m, chunk=8)
    got = ops.wkv_chunked_bwd(r, k, v, lw, u, s0, dy, None, chunk=8)
    want = K.wkv_chunked_bwd_plain(r, k, v, lw, u, s0, dy,
                                   torch.zeros_like(dsf), 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,s,h,d,chunk", [(2, 64, 2, 16, 16),
                                           (1, 64, 3, 64, 16),
                                           (2, 32, 2, 8, 8)])
def test_model_chunked_wkv_grads_match_jax_vjp(b, s, h, d, chunk):
    """The port's ``rwkv6._chunked_wkv`` (the log-decay clamp in torch ops,
    then the Function) against ``jax.vjp`` of the JAX package's
    ``_chunked_wkv`` (its ``lax.scan`` differentiated by XLA) on the same
    float32 inputs and cotangents: the gradients of r, k, v, w, u and S0
    each within 1e-5 relative L2. A few decays lie below e^-5, where both
    clamps pass no gradient; B = 1 hands the kernel's wrapper views."""
    rng = np.random.default_rng(b * 1000 + s + d)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (b, s, h, d)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.05] = 1e-3
    u = (rng.standard_normal((h, d)) * 0.2).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((b, s, h, d)).astype(np.float32)
    gs = rng.standard_normal((b, h, d, d)).astype(np.float32)
    args = (r, k, v, w, u, s0)

    def jfn(*x):
        return jRW._chunked_wkv(*x, chunk)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    leaves = [t(x).requires_grad_() for x in args]
    y, s_fin = RW._chunked_wkv(*leaves, chunk)
    got = torch.autograd.grad((y, s_fin), leaves, (t(gy), t(gs)))
    for name, g, jg in zip(("r", "k", "v", "w", "u", "S0"), got, want):
        jg = torch.from_numpy(np.array(jg))
        assert _rel_l2(g, jg) < 1e-5, (name, _rel_l2(g, jg))
