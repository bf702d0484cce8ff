"""Port parity, kernels: the plain PyTorch versions behind
``repro_torch.kernels.ops`` (what a CPU tensor runs) against the JAX
package's Pallas kernels in interpret mode, on the same numpy codes. Planes
and P must be equal bit for bit. Coverage mirrors tests/test_kernels.py and
the fused-conv geometries of tests/test_fastpath.py: <2:2>, <4:4>, <8:8>,
K not a multiple of 32, N = 131 and 1000, stride 2, padding 1 and 3, odd
widths, prime O and C = 3."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bits_equal, t

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bitserial_matmul as tbsm
from repro_torch.kernels import ops as tops

jpk = importlib.import_module("repro.core.packed")
tpk = importlib.import_module("repro_torch.core.packed")


def _codes(shape, bits, seed):
    return np.random.default_rng(seed).integers(
        0, 2**bits, shape).astype(np.int32)


@pytest.mark.parametrize("m,k,bits", [(8, 32, 1), (64, 128, 8), (16, 96, 2),
                                      (5, 70, 4), (37, 3, 8)])
def test_pack_planes_bit_exact(m, k, bits):
    q = _codes((m, k), bits, seed=m + k)
    got = tops.pack_planes(t(q), bits)
    assert tuple(got.shape) == (bits, m, (k + 31) // 32)
    assert_bits_equal(got, jops.pack_planes(jnp.asarray(q), bits))


@pytest.mark.parametrize("bits", range(9, 17))
@pytest.mark.parametrize("m,k", [(8, 32), (5, 70), (37, 3), (16, 96)])
def test_pack_planes_bit_exact_past_8_bits(m, k, bits):
    """Codes of 9-16 bits, the widest the precision sweep packs, K ragged
    against the word: equal to the Pallas kernel in interpret mode."""
    q = _codes((m, k), bits, seed=m * k + bits)
    q[0] = 2**bits - 1
    got = tops.pack_planes(t(q), bits)
    assert tuple(got.shape) == (bits, m, (k + 31) // 32)
    assert_bits_equal(got, jops.pack_planes(jnp.asarray(q), bits))


@pytest.mark.parametrize("bits", [2, 8, 16])
def test_prepack_packs_through_the_kernel_1_wrapper(monkeypatch, bits):
    """prepack, prepack_conv (both layouts) and _pack_codes pack every
    weight through ``kernels.bitplane_pack.bitplane_pack`` (kernel 1 on a
    CUDA tensor), with planes equal to the JAX package's prepack."""
    from repro_torch.core import bitserial as tbs
    from repro_torch.kernels import bitplane_pack as kp

    calls = []
    real = kp.bitplane_pack

    def spy(q, b):
        calls.append((tuple(q.shape), b))
        return real(q, b)

    monkeypatch.setattr(kp, "bitplane_pack", spy)
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((70, 24)).astype(np.float32)
    cw = rng.standard_normal((3, 3, 40, 9)).astype(np.float32)
    tp, tc = tpk.prepack(t(w), bits), tpk.prepack_conv(t(cw), bits)
    assert calls == [((24, 70), bits), ((9, 360), bits), ((81, 40), bits)]
    jp, jc = jpk.prepack(jnp.asarray(w), bits), jpk.prepack_conv(
        jnp.asarray(cw), bits)
    assert_bits_equal(tp.planes, jp.planes)
    assert_bits_equal(tc.mat.planes, jc.mat.planes)
    assert_bits_equal(tc.fused_planes, jc.fused_planes)
    qw = _codes((70, 24), bits, seed=3)
    pq = tbs._pack_codes(t(qw), tp.wq)
    assert calls[-1] == ((24, 70), bits)
    assert_bits_equal(pq.planes, jops.pack_planes(
        jnp.asarray(np.ascontiguousarray(qw.T)), bits))


@pytest.mark.parametrize("m,k,nn", [(8, 32, 8), (16, 64, 128), (32, 96, 16),
                                    (5, 70, 131), (3, 256, 1000)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bitserial_matmul_prepacked_bit_exact(m, k, nn, bits):
    """The one-launch route (weight planes prepacked, activation codes
    packed inside the kernel), K ragged against the word."""
    qa = _codes((m, k), bits, seed=m * k)
    w = np.random.default_rng(nn).standard_normal((k, nn)).astype(np.float32)
    jp, tp = jpk.prepack(jnp.asarray(w), bits), tpk.prepack(t(w), bits)
    got = tops.bitserial_matmul(t(qa), a_bits=bits, w_bits=bits,
                                pw=tp.planes)
    want = jops.bitserial_matmul(jnp.asarray(qa), a_bits=bits, w_bits=bits,
                                 pw=jp.planes)
    assert_bits_equal(got, want)
    assert_bits_equal(got, jref.bitserial_matmul_codes_ref(
        jnp.asarray(qa), jp.codes))


@pytest.mark.parametrize("ab,wb", [(1, 1), (2, 4), (8, 3)])
def test_bitserial_matmul_from_codes_mixed_bits(ab, wb):
    """Weight planes packed from raw codes, a_bits != w_bits."""
    qa, qw = _codes((16, 100), ab, 1), _codes((100, 24), wb, 2)
    pw = tops.pack_planes(t(np.ascontiguousarray(qw.T)), wb)
    got = tops.bitserial_matmul(t(qa), a_bits=ab, w_bits=wb, pw=pw)
    assert_bits_equal(got, jops.bitserial_matmul(
        jnp.asarray(qa), jnp.asarray(qw), a_bits=ab, w_bits=wb))


def test_packed_matmul_plain_against_oracle_and_wraps():
    """Eq. 1 on random full-width words (bit 31 set) against the JAX
    packed-plane oracle, and int32 wraparound: P beyond 2^31 wraps mod 2^32
    exactly as the reference's int32 accumulation does."""
    rng = np.random.default_rng(7)
    pa = rng.integers(0, 2**32, (4, 9, 3), dtype=np.uint64).astype(np.uint32)
    pw = rng.integers(0, 2**32, (4, 131, 3), dtype=np.uint64).astype(np.uint32)
    assert_bits_equal(tbsm.packed_matmul_plain(t(pa), t(pw)),
                      jref.bitserial_matmul_packed_ref(jnp.asarray(pa),
                                                       jnp.asarray(pw)))
    ones = np.full((8, 1, 2048), 0xFFFFFFFF, np.uint32)   # 2^16 * 255^2 > 2^31
    got = tbsm.packed_matmul_plain(t(ones), t(ones))
    want = jref.bitserial_matmul_packed_ref(jnp.asarray(ones),
                                            jnp.asarray(ones))
    assert_bits_equal(got, want)
    assert int(got[0, 0]) == (65536 * 255 * 255) % 2**32 - 2**32


@pytest.mark.parametrize("shape,o,ks,stride,pad,bits", [
    ((1, 9, 9, 33), 16, 3, 1, 1, 8),     # odd C: one and a bit words
    ((2, 9, 13, 5), 8, 3, 2, 1, 2),      # non-square, odd width, stride 2
    ((2, 9, 13, 5), 8, 3, 2, 1, 4),
    ((2, 9, 13, 5), 8, 3, 2, 1, 8),
    ((1, 6, 6, 8), 131, 3, 1, 1, 4),     # prime O
    ((1, 7, 6, 3), 64, 7, 2, 3, 8),      # the stem: C=3, 7x7/2, padding 3
    ((1, 6, 6, 64), 64, 3, 1, 0, 8),     # no padding
])
def test_conv2d_bitserial_bit_exact(shape, o, ks, stride, pad, bits):
    qx = _codes(shape, bits, seed=sum(shape) + o)
    qx = np.pad(qx, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    w = np.random.default_rng(o).standard_normal(
        (ks, ks, shape[-1], o)).astype(np.float32)
    jp = jpk.prepack_conv(jnp.asarray(w), bits)
    tp = tpk.prepack_conv(t(w), bits)
    got = tops.conv2d_bitserial(t(qx), tp.fused_planes, a_bits=bits,
                                stride=stride)
    want = jops.conv2d_bitserial(jnp.asarray(qx), jp.fused_planes,
                                 a_bits=bits, stride=stride)
    assert_bits_equal(got, want)


def test_plain_versions_do_not_count_launches():
    """A CPU tensor runs the plain version, which is not a launch."""
    tops.reset_launch_counts()
    qa = t(_codes((4, 40), 4, 3))
    pw = tops.pack_planes(t(_codes((8, 40), 4, 4)), 4)
    tops.bitserial_matmul(qa, a_bits=4, w_bits=4, pw=pw)
    qx = t(_codes((1, 5, 5, 8), 4, 5))
    tops.conv2d_bitserial(qx, tpk.prepack_conv(torch.randn(3, 3, 8, 4),
                                               4).fused_planes, a_bits=4)
    tops.bitserial_matmul_packed(tops.pack_planes(qa, 4), pw, a_bits=4,
                                 w_bits=4)
    tops.bitserial_matmul_batched(qa[None], a_bits=4, w_bits=4, pw=pw[None])
    x = torch.zeros((2, 16, 8))
    tops.wkv_chunked(x, x, x, x, torch.zeros((2, 8)), torch.zeros((2, 8, 8)),
                     chunk=8)
    assert tops.launch_counts() == {"bitplane_pack": 0,
                                    "bitserial_matmul_fused": 0,
                                    "bitserial_matmul_packed": 0,
                                    "bitserial_matmul_fused_batched": 0,
                                    "conv2d_bitserial_fused": 0,
                                    "wkv_chunked": 0,
                                    "wkv_chunked_bwd": 0}


def test_wrappers_reject_bad_operands_and_other_devices():
    """No silent fallback: a device that is neither CPU nor CUDA raises, as
    do operands the kernels do not take."""
    q = torch.zeros((4, 40), dtype=torch.int32)
    pw = tops.pack_planes(q, 4)
    with pytest.raises(ValueError, match="device"):
        tops.pack_planes(q.to("meta"), 4)
    with pytest.raises(ValueError, match="device"):
        tops.bitserial_matmul(q.to("meta"), a_bits=4, w_bits=4,
                              pw=pw.to("meta"))
    with pytest.raises(ValueError, match="int32"):
        tops.pack_planes(q.float(), 4)
    with pytest.raises(ValueError, match="exceeds"):
        tops.bitserial_matmul(torch.zeros((4, 70), dtype=torch.int32),
                              a_bits=4, w_bits=4, pw=pw)
    with pytest.raises(ValueError, match="1..16"):
        tops.pack_planes(q, 17)
    with pytest.raises(ValueError, match="weight words"):
        tops.conv2d_bitserial(torch.zeros((1, 5, 5, 40), dtype=torch.int32),
                              torch.zeros((3, 4, 2, 3, 1), dtype=torch.int32),
                              a_bits=4)


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = \"-o\" ]; then out=\"$2\"; fi; shift\n"
                    "done\n" + body)
    nvcc.chmod(0o755)
    return nvcc.parent.parent


@pytest.mark.parametrize("ok", [True, False])
def test_kernel_build_runs_one_nvcc_per_source(tmp_path, monkeypatch, ok):
    """The build machinery with a stand-in nvcc: every kernel builds once
    into a digest-named library with its log kept, a second build does
    nothing, and a failed compile raises with the compiler's output."""
    from repro_torch.kernels import _build

    body = ("echo 'ptxas info : fake'; echo lib > \"$out\"\n" if ok
            else "echo 'error: fake compile error'; exit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, body)))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if not ok:
        with pytest.raises(RuntimeError, match="fake compile error"):
            _build.build()
        assert not list((tmp_path / "build").glob("*.so"))
        return
    times = _build.build()
    assert sorted(times) == sorted(_build.KERNELS)
    for name in _build.KERNELS:
        lib = _build.library_path(name)
        assert lib.parent == tmp_path / "build" and lib.exists()
        log = _build.log_path(name)
        assert log.parent == tmp_path / "build" and log.stem == lib.stem
        assert "ptxas" in log.read_text()
    assert _build.build() == {}
