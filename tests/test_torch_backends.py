"""Port parity, the Eq. 1 backends and kernel 4: every backend of
``repro_torch.core.bitserial`` on a CPU tensor (the kernels' plain
versions) against the JAX package on the same numpy codes, bit for bit.

Kernel 4 (``bitserial_matmul_packed``) is held against the reference's
Pallas kernel in interpret mode and its packed-plane oracle, at the block
sweep and the N = 192 / 320 regression shapes of tests/test_kernels.py.
Each port backend's P equals the reference's ``int_matmul_direct`` at
<2:2>, <4:4> and <8:8> for K from 1 to 4608, ragged K included. The
reference's ``mxu-plane`` builds its 2^(n+m) weights with ``jnp.exp2``,
which XLA on the CPU returns inexact at 2^13, and combines the plane counts
in float32, which rounds once P passes 2^24; the port's ``mxu-plane``
(integer shifts) matches it bit for bit only where neither happens
(a_bits + w_bits < 15 and P < 2^24), and at <8:8> the reference's deviation
is recorded, not copied."""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bits_equal, assert_close, t

from repro.core import bitserial as jbs
from repro.core import bitslice as jbitslice
from repro.kernels import ref as jref
from repro.kernels.bitserial_matmul import bitserial_matmul_packed as jpacked
from repro_torch.core import bitserial as tbs
from repro_torch.kernels import bitserial_matmul as tbsm
from repro_torch.kernels import ops as tops

jpk = importlib.import_module("repro.core.packed")
tpk = importlib.import_module("repro_torch.core.packed")
jq = importlib.import_module("repro.core.quantize")
tq = importlib.import_module("repro_torch.core.quantize")


def _codes(shape, bits, seed):
    return np.random.default_rng(seed).integers(
        0, 2**bits, shape).astype(np.int32)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# -- kernel 4: Eq. 1 on two prepacked plane sets -----------------------------

@pytest.mark.parametrize("bm,bn,bkw", [(8, 128, 1), (16, 128, 2), (8, 256, 4)])
def test_packed_matmul_block_sweep(bm, bn, bkw):
    """The reference kernel's BlockSpec tilings and the port's wrapper (no
    tiles: the CUDA kernel masks ragged edges in place) agree with the
    packed-plane oracle."""
    pa, pw = _words((4, 16, 4), bm + bn), _words((4, 256, 4), bkw)
    want = jpacked(jnp.asarray(pa), jnp.asarray(pw), a_bits=4, w_bits=4,
                   bm=bm, bn=bn, bkw=bkw, interpret=True)
    got = tops.bitserial_matmul_packed(t(pa), t(pw), a_bits=4, w_bits=4)
    assert_bits_equal(got, want)
    assert_bits_equal(got, jref.bitserial_matmul_packed_ref(
        jnp.asarray(pa), jnp.asarray(pw)))


@pytest.mark.parametrize("bn", [192, 320])
def test_packed_matmul_non_multiple_of_128_n(bn):
    """The shapes of the reference's silent-drop regression: every column,
    the trailing bn % 128 ones included."""
    pa, pw = _words((4, 8, 2), 10), _words((4, bn, 2), 11)
    want = jpacked(jnp.asarray(pa), jnp.asarray(pw), a_bits=4, w_bits=4,
                   bm=8, bn=bn, bkw=2, interpret=True)
    got = tbsm.bitserial_matmul_packed(t(pa), t(pw), 4, 4)
    assert_bits_equal(got, want)
    assert_bits_equal(got[:, 128:], np.asarray(want)[:, 128:])


@pytest.mark.parametrize("ab,wb,m,kw,n", [(1, 1, 8, 1, 8), (2, 4, 5, 3, 131),
                                          (8, 8, 8, 9, 1000)])
def test_packed_matmul_ragged_against_oracle(ab, wb, m, kw, n):
    pa, pw = _words((ab, m, kw), m * n), _words((wb, n, kw), kw)
    assert_bits_equal(tops.bitserial_matmul_packed(t(pa), t(pw), a_bits=ab,
                                                   w_bits=wb),
                      jref.bitserial_matmul_packed_ref(jnp.asarray(pa),
                                                       jnp.asarray(pw)))


def test_packed_matmul_rejects_bad_operands():
    pa = t(_words((4, 8, 2), 0))
    with pytest.raises(ValueError, match="weight words"):
        tops.bitserial_matmul_packed(pa, t(_words((4, 8, 3), 1)), a_bits=4,
                                     w_bits=4)
    with pytest.raises(ValueError, match="planes"):
        tops.bitserial_matmul_packed(pa, t(_words((4, 8, 2), 1)), a_bits=2,
                                     w_bits=4)
    with pytest.raises(ValueError, match="1..8"):
        tbsm.bitserial_matmul_packed(t(_words((9, 8, 2), 0)),
                                     t(_words((9, 8, 2), 1)), 9, 9)
    with pytest.raises(ValueError, match="device"):
        tops.bitserial_matmul_packed(pa.to("meta"), pa.to("meta"), a_bits=4,
                                     w_bits=4)


# -- the four backends against the reference's int_matmul_direct ------------

_KS = [1, 31, 32, 33, 100, 363, 1000, 4608]


@pytest.mark.parametrize("k", _KS)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("backend", tbs.BACKENDS)
def test_backend_equals_reference_int_direct(backend, bits, k):
    qa, qw = _codes((5, k), bits, k), _codes((k, 7), bits, k + 1)
    want = jbs.int_matmul_direct(jnp.asarray(qa), jnp.asarray(qw))
    assert_bits_equal(tbs.int_matmul(t(qa), t(qw), bits, bits, backend), want)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("backend", tbs.BACKENDS)
def test_prepacked_backend_equals_reference(backend, bits):
    """The deployment path: weights prepacked once, activation codes per
    call; P equals the reference's prepacked int-direct P."""
    qa = _codes((6, 300), bits, 3)
    w = np.random.default_rng(4).standard_normal((300, 45)).astype(np.float32)
    jp, tp = jpk.prepack(jnp.asarray(w), bits), tpk.prepack(t(w), bits)
    assert_bits_equal(tp.codes32, jp.codes)
    assert_bits_equal(tbs.int_matmul_prepacked(t(qa), tp, bits, backend),
                      jbs.int_matmul_prepacked(jnp.asarray(qa), jp, bits,
                                               "int-direct"))


@pytest.mark.parametrize("case", ["uint8", "int32", "wrap", "leading",
                                  "16-bit", "bank"])
def test_int_direct_byte_route_equals_the_reference(case):
    """On the CPU, byte codes of a 2-D weight take int-direct's int8 GEMM
    (``_int_mm_bytes``): uint8 or int32 weight codes, all-255 codes at
    K = 40,000 (P wraps mod 2^32), leading activation dims; 16-bit codes
    and an expert bank (E, K, N) take the float64 product. Each equals the
    reference's ``int_matmul_direct`` bit for bit (a bank, which the
    reference contracts under ``vmap``, equals numpy's batched product)."""
    shape_a, shape_w, bits = {
        "uint8": ((3, 700), (700, 9), 8), "int32": ((3, 700), (700, 9), 8),
        "wrap": ((2, 40000), (40000, 3), 8),
        "leading": ((2, 3, 64), (64, 5), 8),
        "16-bit": ((4, 64), (64, 8), 16), "bank": ((3, 4, 64), (3, 64, 5), 8),
    }[case]
    qa, qw = _codes(shape_a, bits, 7), _codes(shape_w, bits, 8)
    if case == "wrap":
        qa[:], qw[:] = 255, 255
    tw = t(qw).to(torch.uint8) if case in ("uint8", "wrap", "bank") else t(qw)
    assert tbs._byte_codes(t(qa), tw) == (case not in ("16-bit", "bank"))
    want = (np.matmul(qa.astype(np.int64), qw.astype(np.int64)).astype(
        np.int32) if case == "bank" else
        jbs.int_matmul_direct(jnp.asarray(qa), jnp.asarray(qw)))
    assert_bits_equal(tbs.int_matmul_direct(t(qa), tw), want)


def test_backends_wrap_mod_2_32_like_the_reference():
    """At 16 bits the int32 product wraps; int-direct and mxu-plane (the
    backends that take more than 8 bits) wrap exactly as the reference."""
    qa, qw = _codes((4, 64), 16, 5), _codes((64, 8), 16, 6)
    want = jbs.int_matmul_direct(jnp.asarray(qa), jnp.asarray(qw))
    assert (np.asarray(want).astype(np.int64)
            != qa.astype(np.int64) @ qw.astype(np.int64)).any()
    for backend in ("int-direct", "mxu-plane"):
        assert_bits_equal(tbs.int_matmul(t(qa), t(qw), 16, 16, backend), want)
    for backend in ("popcount", "cuda"):
        with pytest.raises(ValueError, match="1..8"):
            tbs.int_matmul(t(qa), t(qw), 16, 16, backend)


@pytest.mark.parametrize("ab,wb,k", [(2, 2, 4608), (4, 4, 4608),
                                     (8, 3, 4608), (1, 8, 4608),
                                     (7, 7, 1000)])
def test_mxu_plane_equals_reference_below_15_bits(ab, wb, k):
    """Where the reference is exact: a_bits + w_bits < 15 and every P
    below 2^24 ((2^a - 1)(2^w - 1)K < 2^24)."""
    assert (2**ab - 1) * (2**wb - 1) * k < 2**24
    qa, qw = _codes((9, k), ab, 7), _codes((k, 11), wb, 8)
    assert_bits_equal(tbs.int_matmul_mxu_plane(t(qa), t(qw), ab, wb),
                      jbs.int_matmul_mxu_plane(jnp.asarray(qa),
                                               jnp.asarray(qw), ab, wb))


def test_mxu_plane_at_8_8_records_the_reference_deviation():
    """<8:8>: the port's mxu-plane is exact. The reference's is exact only
    with plane weights that are powers of two: at K=256 every P is below
    2^24, so its float32 combine cannot round and any deviation is the
    weights'. At K=4608 its float32 combine rounds too."""
    for k in (256, 4608):
        qa, qw = _codes((64, k), 8, 9), _codes((k, 16), 8, 10)
        direct = np.asarray(jbs.int_matmul_direct(jnp.asarray(qa),
                                                  jnp.asarray(qw)))
        assert_bits_equal(tbs.int_matmul_mxu_plane(t(qa), t(qw), 8, 8),
                          direct)
        ref = np.asarray(jbs.int_matmul_mxu_plane(jnp.asarray(qa),
                                                  jnp.asarray(qw), 8, 8))
        dev = int(np.abs(ref.astype(np.int64) - direct).max())
        weights = np.asarray(jbitslice.plane_weights(8, 8), np.float64)
        exact = np.array_equal(weights, 2.0 ** np.add.outer(np.arange(8),
                                                            np.arange(8)))
        if k == 256 and exact:
            assert dev == 0
        if dev:
            warnings.warn(f"reference mxu-plane <8:8> at K={k} misses "
                          f"int_matmul_direct by up to {dev} (plane weights "
                          f"exact: {exact}); the port's is exact")


@pytest.mark.parametrize("backend", tbs.BACKENDS)
def test_quantized_matmul_legacy_codes_match_reference(backend):
    """``quantized_matmul`` with pre-quantized ``wq``/``qw``."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((3, 4, 70)).astype(np.float32)
    w = rng.standard_normal((70, 9)).astype(np.float32)
    jwq = jq.calibrate_minmax(jnp.asarray(w), 4)
    twq = tq.calibrate_minmax(t(w), 4)
    jqw, tqw = jq.quantize(jnp.asarray(w), jwq), tq.quantize(t(w), twq)
    assert_bits_equal(tqw, jqw)
    got = tbs.quantized_matmul(t(a), t(w), a_bits=4, w_bits=4,
                               backend=backend, wq=twq, qw=tqw)
    want = jbs.quantized_matmul(jnp.asarray(a), jnp.asarray(w), a_bits=4,
                                w_bits=4, backend="int-direct", wq=jwq,
                                qw=jqw)
    assert got.shape == (3, 4, 9)
    assert_close(got, want, rtol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("backend", tbs.BACKENDS)
def test_quantized_matmul_float_weight_equals_prepacked(backend, bits):
    """A float weight quantized per call (on the code backends without
    planes) gives the output of its ``prepack`` bit for bit."""
    from repro_torch.core.packed import prepack

    rng = np.random.default_rng(13)
    a = t(rng.standard_normal((5, 70)).astype(np.float32))
    w = t(rng.standard_normal((70, 33)).astype(np.float32))
    got = tbs.quantized_matmul(a, w, bits, bits, backend=backend)
    want = tbs.quantized_matmul(a, prepack(w, bits), bits, bits,
                                backend=backend)
    assert torch.equal(got, want)


def test_unknown_backend_raises():
    from repro_torch.core import PIMQuantConfig

    with pytest.raises(ValueError, match="backend"):
        tbs.int_matmul(t(_codes((2, 4), 2, 0)), t(_codes((4, 2), 2, 1)), 2, 2,
                       "pallas")
    with pytest.raises(ValueError, match="backend"):
        PIMQuantConfig(8, 8, backend="pallas")
    assert PIMQuantConfig(4, 2, backend="popcount").tag == "<4:2>"
