"""Kernel 5's launch plan (``kernels/rwkv_chunk.py::_plan``) at every
shape ``chip_smoke.py`` holds it at and every prefill chunk rwkv6-3b gives
it, and the batch-1 layout the caller hands it.

The plan decides the grid (BH * D / cols blocks), the state tile of a
thread and the shared memory of a block, so it is checked here where no
card is: the columns tile D in whole 16-byte words, a block's state slice
is at most one 4 x TJ tile for each of its 512 threads, the staged tokens
are whole chunks that fit in shared memory and one pass of its threads, and a batch-1 prefill of
rwkv6-3b fills the card in one wave."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv_chunk as K
from repro_torch.models.lm import rwkv6 as RW

H100_SMS = 132


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()
# rwkv6-3b (40 heads of 64): every power-of-two prefill chunk of 16 or more
# tokens up to the 512-token prompt, at batch 1 and 2.
_SERVED = [(b * 40, s, 64, 16) for b in (1, 2) for s in (16, 32, 64, 128,
                                                         256, 512)]
_ROWS = sorted(set(_SMOKE.WKV_ROWS) | set(_SMOKE.WKV_EDGES) | set(_SERVED)
               | {(40, 256, 64, 16), (8, 48, 32, 16)})


def _tile_j(d, cols):
    return d * cols // (4 * K.THREADS) if d * cols > 4 * K.THREADS else 1


@pytest.mark.parametrize("bh,s,d,chunk", _ROWS)
def test_plan_is_one_the_kernel_takes(bh, s, d, chunk):
    plan = K._plan(bh, s, d, chunk, H100_SMS)
    assert plan.cols % 8 == 0 and d % plan.cols == 0
    assert plan.tokens % chunk == 0 and chunk <= plan.tokens <= max(64, chunk)
    assert plan.tokens <= s
    assert plan.tokens * d <= 8 * K.THREADS
    tj = _tile_j(d, plan.cols)
    assert tj in (1, 2, 4) and (d // 4) * (plan.cols // tj) <= K.THREADS
    assert K.smem_bytes(d, plan.cols, plan.tokens, chunk) <= K.SMEM_LIMIT


@pytest.mark.parametrize("s", [16, 64, 256, 512])
def test_batch_1_prefill_fills_the_card_in_one_wave(s):
    """40 heads: 80 blocks of 32 columns, each head's A computed twice,
    rather than 160 blocks of 16 in two waves or 40 blocks of 64."""
    plan = K._plan(40, s, 64, 16, H100_SMS)
    assert plan.cols == 32 and 40 * 64 // plan.cols <= H100_SMS
    assert plan.tokens == min(64, s)


def test_enough_heads_take_whole_heads():
    """Where whole heads already fill the card, a block owns all D columns
    and A is computed once per (head, chunk)."""
    assert K._plan(80, 256, 64, 16, H100_SMS).cols == 64
    assert K._plan(2 * H100_SMS, 256, 64, 16, H100_SMS).cols == 64
    assert K._plan(40, 256, 64, 16, 40).cols == 64


def test_smem_bytes_counts_the_layout():
    """Two staging buffers of r, k, lw and v, r u k, dS_c / S_c per chunk,
    A' (a row of chunk + 4 a key), e^{P_L} per chunk and u, in floats."""
    d, cols, tokens, chunk = 64, 32, 64, 16
    ldd, ldv = d + 4, cols + 4
    words = (2 * (3 * tokens * ldd + tokens * ldv) + tokens * ldd
             + 4 * d * ldv + tokens * (chunk + 4) + 4 * d + d)
    assert K.smem_bytes(d, cols, tokens, chunk) == 4 * words == 183552


def test_batch_1_prefill_hands_the_kernel_views(monkeypatch):
    """At B = 1 ``_chunked_wkv`` passes r, k and v as (H, S, D) views of
    the (1, S, H, D) projections (no copy) and returns y in that layout;
    at B = 2 the heads are laid out as (B*H, S, D) copies."""
    seen = []
    real = K.wkv_chunked

    def spy(r, k, v, lw, u, s0, chunk):
        seen.append((r, k, v, lw))
        return real(r, k, v, lw, u, s0, chunk)

    monkeypatch.setattr(K, "wkv_chunked", spy)
    rng = np.random.default_rng(0)
    h, d, s = 4, 16, 32
    for b in (1, 2):
        r, k, v = (torch.from_numpy(rng.standard_normal(
            (b, s, h, d)).astype(np.float32)) for _ in range(3))
        w = torch.from_numpy(rng.uniform(0.5, 0.99, (b, s, h, d)).astype(
            np.float32))
        u = torch.zeros((h, d))
        s0 = torch.zeros((b, h, d, d))
        y, s_last = RW._chunked_wkv(r, k, v, w, u, s0, 16)
        tr, tk, tv, tl = seen[-1]
        assert tuple(y.shape) == (b, s, h, d) and tuple(s_last.shape) == (
            b, h, d, d)
        if b == 1:
            for got, src in ((tr, r), (tk, k), (tv, v)):
                assert got.data_ptr() == src.data_ptr()
                assert got.stride() == (d, h * d, 1)
            assert tl.stride() == (d, h * d, 1)
        else:
            assert tr.is_contiguous() and tr.data_ptr() != r.data_ptr()
