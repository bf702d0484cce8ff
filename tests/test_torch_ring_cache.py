"""The port's local attention and its ring-buffer cache against the JAX
package on the CPU: ``update_ring_cache``, the ring's state (float even
with ``kv_quant``), the windowed mask on the no-cache path, decode past
the window, and chunked prefill whose chunks start at offsets above 0 and
cross the window.

Inputs are made with numpy from a seed and given to both packages, at
``recurrentgemma-9b``'s ``reduced()`` width in float32 (window 64, one KV
head of 32 for four query heads). ``update_ring_cache`` places given
rows, compared bit for bit; attention outputs and the rings it fills (each
package's own k and v) within 1e-5 of the largest value. The reference's
ring branch runs jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import attention as jA
from repro.models.lm import cache as jC
from repro.models.lm import model as jM
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import cache as C
from repro_torch.models.lm import model as M

from _torch_parity import (assert_bits_equal, assert_close, hybrid_cfgs,
                           hybrid_params, normal, t)

WINDOW = 64


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def local():
    """The local_attn block of reduced recurrentgemma-9b, float32, in both
    packages."""
    jc, tc = hybrid_cfgs()
    assert jc.local_window == tc.local_window == WINDOW
    jp, tp = hybrid_params(jc)
    pos = jc.blocks.index("local_attn")
    return dict(jc=jc, tc=tc,
                jp=jax.tree.map(lambda x: x[0], jp["scan"][pos]["attn"]),
                tp={k: v[0] for k, v in tp["scan"][pos]["attn"].items()})


def _ring_pair(cfg_pair, b, w, seed=0):
    """A ring of ``w`` rows filled from a numpy seed, in both packages."""
    rng = np.random.default_rng(seed)
    shape = (b, w, cfg_pair[1].n_kv_heads, cfg_pair[1].head_dim)
    k, v = normal(rng, shape), normal(rng, shape)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": t(k), "v": t(v)})


def test_update_ring_cache_writes_slot_index_mod_window():
    jc, tc = hybrid_cfgs()
    jring, tring = _ring_pair((jc, tc), 3, 8)
    rng = np.random.default_rng(1)
    for index in (np.array([0, 7, 21], np.int32), np.int32(13)):
        kn = normal(rng, (3, 1, tc.n_kv_heads, tc.head_dim))
        vn = normal(rng, kn.shape)
        jring = jC.update_ring_cache(jring, jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(index))
        got = C.update_ring_cache(tring, t(kn), t(vn), torch.as_tensor(index))
        assert got is tring
        for name in ("k", "v"):
            assert_bits_equal(tring[name], jring[name])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_ring_state_is_float_and_window_long(kv_quant):
    """``init_layer_state`` sizes the ring min(window, max_len) and keeps it
    float with ``kv_quant`` (no scales), as the reference does."""
    jc, tc = hybrid_cfgs(kv_quant=kv_quant)
    for max_len in (40, 200):
        want = jC.init_layer_state("local_attn", jc, 2, max_len,
                                   dtype=jnp.float32)
        got = C.init_layer_state("local_attn", tc, 2, max_len,
                                 dtype=torch.float32)
        assert sorted(got) == sorted(want) == ["k", "v"]
        for name in got:
            assert tuple(got[name].shape) == want[name].shape == (
                2, min(WINDOW, max_len), 1, 32)
            assert got[name].dtype == torch.float32
    st = M.init_state(tc, 2, 100, device="cpu")
    jst = jM.init_state(jc, 2, 100)
    ring = st["scan"][tc.blocks.index("local_attn")]
    jring = jst["scan"][jc.blocks.index("local_attn")]
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in ring.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jring.items()}
    rg = st["scan"][0]
    assert {k: v.dtype for k, v in rg.items()} == {
        "conv": torch.float32, "h": torch.float32}
    assert tuple(rg["conv"].shape) == (1, 2, 3, 128)


@pytest.mark.parametrize("s", [40, 100])
def test_windowed_mask_on_the_no_cache_path(local, s):
    """``forward``'s path: each query attends to its last ``window``
    positions (S = 100 crosses the window of 64)."""
    x = normal(np.random.default_rng(s), (2, s, local["tc"].d_model))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want, _ = jax.jit(lambda p, x, pos: jA.attention(
        p, local["jc"], x, pos, window=WINDOW))(local["jp"], jnp.asarray(x),
                                                jnp.asarray(pos))
    got, cache = A.attention(local["tp"], local["tc"], t(x), t(pos),
                             window=WINDOW)
    assert cache is None
    assert_close(got, want, rtol=1e-5)
    if s > WINDOW:   # the window matters: the unwindowed output differs
        full, _ = A.attention(local["tp"], local["tc"], t(x), t(pos))
        assert not torch.allclose(full, got, atol=1e-3)


def _jax_ring_attention(local):
    """The reference's ring branch, jitted (one compile per chunk
    length)."""
    jc = local["jc"]
    return jax.jit(lambda p, x, pos, cache, idx: jA.attention(
        p, jc, x, pos, cache=cache, cache_index=idx, window=WINDOW,
        ring=True))


def _run_chunks(local, x, chunks, with_jax=True):
    """Prefill ``x`` (B, S, d) chunk by chunk from position 0 into a fresh
    ring, in the port and (``with_jax``) the JAX package. Returns the
    outputs (port, JAX) of each chunk and the rings."""
    jc, tc = local["jc"], local["tc"]
    b = x.shape[0]
    jattn = _jax_ring_attention(local)
    jring = jC.init_ring_cache(jc, b, WINDOW, dtype=jnp.float32)
    tring = C.init_ring_cache(tc, b, WINDOW, dtype=torch.float32)
    outs, pos0 = [], 0
    for c in chunks:
        idx = np.full((b,), pos0, np.int32)
        qpos = idx[:, None] + np.arange(c, dtype=np.int32)[None]
        xc = x[:, pos0:pos0 + c]
        jo = None
        if with_jax:
            jo, jring = jattn(local["jp"], jnp.asarray(xc), jnp.asarray(qpos),
                              jring, jnp.asarray(idx))
        to, got = A.attention(local["tp"], tc, t(xc), t(qpos), cache=tring,
                              cache_index=t(idx), window=WINDOW, ring=True)
        assert got is tring
        outs.append((to, jo))
        pos0 += c
    return outs, tring, jring


def _rings_close(tring, jring):
    """The rings hold the same tokens in the same slots: k and v are each
    package's own projections, so within 1e-5, and a slot holding another
    position would miss by O(1)."""
    for name in ("k", "v"):
        assert_close(tring[name], np.asarray(jring[name]), rtol=1e-5)


@pytest.mark.parametrize("chunks", [
    (64, 4, 2),            # 70 tokens: fills the ring, then wraps
    (128, 4, 1),           # a chunk longer than the window writes its tail
    (16, 16, 32, 64, 8),   # 136 in five chunks, one exactly the window
    (128, 64, 8),          # 200
])
def test_chunked_prefill_crosses_the_window(local, chunks):
    """Chunks at offsets above 0 attend over the ring as it was before the
    chunk plus their own tokens; the ring then holds each slot's last
    token. Outputs within 1e-5 chunk by chunk, and the rings."""
    x = normal(np.random.default_rng(sum(chunks)),
               (2, sum(chunks), local["tc"].d_model))
    outs, tring, jring = _run_chunks(local, x, chunks)
    for got, want in outs:
        assert_close(got, want, rtol=1e-5)
    _rings_close(tring, jring)


def test_chunked_prefill_equals_the_whole_prompt(local):
    """The chunked ring prefill gives the same outputs as one windowed
    pass over the whole prompt (the port alone)."""
    s = 150
    x = normal(np.random.default_rng(5), (1, s, local["tc"].d_model))
    outs, _, _ = _run_chunks(local, x, (128, 16, 4, 2), with_jax=False)
    pos = torch.arange(s, dtype=torch.int32)[None]
    whole, _ = A.attention(local["tp"], local["tc"], t(x), pos,
                           window=WINDOW)
    got = torch.cat([o for o, _ in outs], dim=1)
    assert_close(got, whole.numpy(), rtol=1e-5)


def test_ring_decode_past_the_window(local):
    """A 70-token prefill, then 70 decode steps at per-slot positions (the
    two slots 9 apart): each step writes slot index % w first, then
    attends over the ring; outputs within 1e-5, and the rings."""
    tc = local["tc"]
    rng = np.random.default_rng(7)
    x = normal(rng, (2, 70, tc.d_model))
    _, tring, jring = _run_chunks(local, x, (64, 4, 2))
    jattn = _jax_ring_attention(local)
    idx = np.array([70, 79], np.int32)
    for step in range(70):
        xs = normal(rng, (2, 1, tc.d_model))
        jo, jring = jattn(local["jp"], jnp.asarray(xs),
                          jnp.asarray(idx[:, None]), jring, jnp.asarray(idx))
        to, _ = A.attention(local["tp"], tc, t(xs), t(idx[:, None]),
                            cache=tring, cache_index=t(idx), window=WINDOW,
                            ring=True)
        assert_close(to, jo, rtol=1e-5)
        idx = idx + 1
    _rings_close(tring, jring)


def test_ring_slot_never_written_is_masked(local):
    """A fresh ring holds zeros at derived positions below 0: a 3-token
    chunk at position 0 attends only to itself, as the no-cache path."""
    x = normal(np.random.default_rng(8), (1, 3, local["tc"].d_model))
    outs, _, _ = _run_chunks(local, x, (3,), with_jax=False)
    pos = torch.arange(3, dtype=torch.int32)[None]
    want, _ = A.attention(local["tp"], local["tc"], t(x), pos,
                          window=WINDOW)
    assert_close(outs[0][0], want.numpy(), rtol=1e-6)


def test_kv_quant_leaves_the_ring_float():
    """With ``kv_quant`` the ring still stores float k and v, and a
    kv_quant model's forward, prefill and decode equal the float model's
    (recurrentgemma has no global attention layer to quantize)."""
    jc, tc = hybrid_cfgs()
    _, tp = hybrid_params(jc)
    tq = dataclasses.replace(tc, kv_quant=True)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tc.vocab, (1, 20)).astype(np.int64))
    logits = []
    for cfg in (tc, tq):
        st = M.init_state(cfg, 1, 32, device="cpu")
        lo, st = M.prefill(tp, cfg, toks, st)
        lo2, st = M.decode_step(tp, cfg, toks[:, :1], st)
        ring = st["scan"][cfg.blocks.index("local_attn")]
        assert sorted(ring) == ["k", "v"]
        assert ring["k"].dtype == torch.float32
        logits.append((lo, lo2))
    for a, b in zip(*logits):
        assert torch.equal(a, b)
