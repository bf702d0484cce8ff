"""The port's KV cache against the JAX package on the CPU: ``quantize_kv``
bit for bit, ``update_kv_cache`` at per-slot offsets and the whole-length
branch, one attention block prefilled and decoded against the cache
(float and int8), chunked prefill into a reused slot, the int8 cache's
decode against the JAX package's, and the counterparts of
``tests/test_kv_quant.py``.

Inputs are made with numpy from a seed and given to both packages; the
models run at their ``reduced()`` width in float32 unless a test says
otherwise, with the QKV biases (qwen1.5) and qk-norm scales (qwen3) drawn
from numpy so that their paths count.
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

from _torch_parity import (assert_bits_equal, assert_close, dense_cfgs,
                           dense_models, n, normal, rel_err, t)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dense():
    """Each dense arch, reduced, float32: configs and one set of weights in
    both packages."""
    return dense_models()


# -- KV cache ------------------------------------------------------------------------

def test_quantize_kv_codes_and_scales_bit_for_bit():
    rng = np.random.default_rng(9)
    x = normal(rng, (2, 40, 4, 32), 3.0)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 1e-30
    x[1, 3, 2, :4] = [1.5, -1.5, 2.5, 127.0]   # ties at half a code
    jq, js = jC.quantize_kv(jnp.asarray(x))
    tq, ts = C.quantize_kv(t(x))
    assert_bits_equal(tq, jq)
    assert_bits_equal(ts, js)


def test_quantize_kv_roundtrip_bound():
    """Counterpart of tests/test_kv_quant.py's test of that name."""
    x = t(normal(np.random.default_rng(10), (2, 8, 4, 16), 3.0))
    q, scale = C.quantize_kv(x)
    assert q.dtype == torch.int8
    back = q.to(torch.float32) * scale[..., None]
    assert float((back - x).abs().max()) <= float(scale.max()) * 0.5 + 1e-6


@pytest.mark.parametrize("kv_quant", [False, True])
def test_update_kv_cache_at_per_slot_offsets(kv_quant):
    """Three sequences at offsets 0, 5 and 11 of a 16-row cache: the new
    rows land at each one's offset, in place, the rest untouched, as the
    JAX package writes them."""
    jc, tc = dense_cfgs("llama3.2-3b", kv_quant=kv_quant)
    rng = np.random.default_rng(11)
    jcache = {k: v + 1 for k, v in jC.init_kv_cache(
        jc, 3, 16, dtype=jnp.float32).items()}    # rows not to be touched
    tcache = {k: t(v) for k, v in jcache.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    index = np.array([0, 5, 11], np.int32)
    for s_new in (4, 1):
        kn = normal(rng, (3, s_new, jc.n_kv_heads, jc.head_dim))
        vn = normal(rng, (3, s_new, jc.n_kv_heads, jc.head_dim))
        jcache = jC.update_kv_cache(jcache, jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.asarray(index))
        out = C.update_kv_cache(tcache, t(kn), t(vn), t(index))
        assert out is tcache
        index = index + s_new
    assert {k: v.data_ptr() for k, v in tcache.items()} == ptrs
    for k in jcache:
        assert_bits_equal(tcache[k], jcache[k])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_update_kv_cache_whole_length_replaces(kv_quant):
    jc, tc = dense_cfgs("qwen3-0.6b", kv_quant=kv_quant)
    rng = np.random.default_rng(12)
    kn, vn = (normal(rng, (2, 8, jc.n_kv_heads, jc.head_dim))
              for _ in range(2))
    jcache = jC.update_kv_cache(jC.init_kv_cache(jc, 2, 8, dtype=jnp.float32),
                                jnp.asarray(kn), jnp.asarray(vn), 3)
    tcache = C.update_kv_cache(C.init_kv_cache(tc, 2, 8, dtype=torch.float32),
                               t(kn), t(vn), 3)
    for k in jcache:
        assert_bits_equal(tcache[k], jcache[k])


@pytest.mark.parametrize("arch,kv_quant", [("qwen1.5-4b", False),
                                           ("qwen3-0.6b", False),
                                           ("llama3.2-3b", True)])
def test_attention_prefill_then_decode_against_cache(dense, arch, kv_quant):
    """One attention block with a cache: a chunk of 8 at offset 0, a chunk
    of 4 at offset 8 (attending over the cached rows), then two decode
    steps with the two sequences at different offsets. Outputs within rtol
    1e-5 and the caches equal (codes and scales bit for bit)."""
    d = dense[arch]
    jc, tc = (dataclasses.replace(c, kv_quant=kv_quant)
              for c in (d["jc"], d["tc"]))
    jp = jax.tree.map(lambda x: x[0], d["jp"]["scan"][0]["attn"])
    tp = {k: v[0] for k, v in d["tp"]["scan"][0]["attn"].items()}
    b, max_len = 2, 24
    jcache = jC.init_kv_cache(jc, b, max_len, dtype=jnp.float32)
    tcache = C.init_kv_cache(tc, b, max_len, dtype=torch.float32)
    rng = np.random.default_rng(13)
    steps = [(np.zeros(b, np.int32), 8), (np.full(b, 8, np.int32), 4),
             (np.array([12, 9], np.int32), 1), (np.array([13, 10], np.int32),
                                                1)]
    for idx, s in steps:
        x = normal(rng, (b, s, jc.d_model))
        pos = (idx[:, None] + np.arange(s)[None]).astype(np.int32)
        with jax.disable_jit():
            want, jcache = jA.attention(jp, jc, jnp.asarray(x),
                                        jnp.asarray(pos), cache=jcache,
                                        cache_index=jnp.asarray(idx))
        got, tcache = A.attention(tp, tc, t(x), t(pos), cache=tcache,
                                  cache_index=t(idx))
        assert_close(got, want, rtol=1e-5)
    for k in jcache:
        if kv_quant:
            assert_bits_equal(tcache[k], jcache[k])
        else:
            assert_close(tcache[k], jcache[k], rtol=1e-5)


def test_prefill_into_slot_chunks_match_jax(dense):
    """Chunks 16 + 4 + 1 of a 21-token prompt into slot 1 of a 3-slot
    grid, over a slot another prompt used: last logits and the slot's KV
    rows as the JAX package's; the other slots untouched."""
    d = dense["qwen3-0.6b"]
    rng = np.random.default_rng(16)
    old = rng.integers(0, d["jc"].vocab, (1, 30)).astype(np.int32)
    toks = rng.integers(0, d["jc"].vocab, (1, 21)).astype(np.int32)
    jst = jM.init_state(d["jc"], 3, 40)
    tst = M.init_state(d["tc"], 3, 40, device="cpu")
    _, jst = jM.prefill_into_slot(d["jp"], d["jc"], jnp.asarray(old), jst,
                                  1, 0)
    _, tst = M.prefill_into_slot(d["tp"], d["tc"], t(old), tst, 1, 0)
    other = tst["scan"][0]["k"][:, [0, 2]].clone()
    pos = 0
    for c in (16, 4, 1):
        jl, jst = jM.prefill_into_slot(d["jp"], d["jc"], jnp.asarray(
            toks[:, pos:pos + c]), jst, 1, pos)
        tl, tst = M.prefill_into_slot(d["tp"], d["tc"], t(
            toks[:, pos:pos + c]), tst, 1, pos)
        pos += c
    assert_close(tl, jl, rtol=1e-5)
    assert tst["length"].tolist() == [0, 21, 0]
    assert torch.equal(tst["scan"][0]["k"][:, [0, 2]], other)
    assert_close(tst["scan"][0]["k"][:, 1, :21],
                 np.asarray(jst["scan"][0]["k"])[:, 1, :21], rtol=1e-5)
    # A fresh request zeroes the slot's rows on its first chunk.
    assert not tst["scan"][0]["k"][:, 1, 21:].any()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-2b"])
def test_kv_quant_decode_matches_jax(dense, arch):
    """int8 KV cache, prefill of 12 tokens then one decode step, against
    the eager JAX package. The two packages' matmuls sum in other orders,
    so k and v differ by an ulp or so (scales within 1e-6), and an ulp can
    flip a code at a rounding boundary, which later layers carry on. At
    one layer the codes are equal and the logits within rtol 1e-5; at the
    reduced depth (4 layers) a few codes (under 1%) move by one step, the
    scales within 1e-3 and the logits within 1e-2 of their largest."""
    d = dense[arch]
    toks = np.random.default_rng(17).integers(0, d["jc"].vocab, (2, 13)).astype(np.int32)
    for layers in (1, 4):
        jc, tc = (dataclasses.replace(c, kv_quant=True, n_layers=layers)
                  for c in (d["jc"], d["tc"]))
        jp = dict(d["jp"], scan=[jax.tree.map(lambda x: x[:layers],
                                              d["jp"]["scan"][0])])
        tp = dict(d["tp"], scan=[{k: jax.tree.map(lambda x: x[:layers], v)
                                  for k, v in d["tp"]["scan"][0].items()}])
        jst = jM.init_state(jc, 2, 16)
        tst = M.init_state(tc, 2, 16, device="cpu")
        with jax.disable_jit():
            _, jst = jM.prefill(jp, jc, jnp.asarray(toks[:, :12]), jst)
            jl, jst = jM.decode_step(jp, jc, jnp.asarray(toks[:, 12:]),
                                     jst)
        _, tst = M.prefill(tp, tc, t(toks[:, :12]), tst)
        tl, tst = M.decode_step(tp, tc, t(toks[:, 12:]), tst)
        for k in ("k", "v"):
            got, want = n(tst["scan"][0][k]), np.asarray(jst["scan"][0][k])
            assert got.dtype == np.int8
            moved = got != want
            assert moved.mean() < (1e-2 if layers > 1 else 1e-12)
            assert np.abs(got.astype(int) - want)[moved].max(
                initial=0) <= 1
            assert_close(tst["scan"][0][k + "_scale"],
                         jst["scan"][0][k + "_scale"],
                         rtol=1e-6 if layers == 1 else 1e-3)
        if layers == 1:
            assert_close(tl, jl, rtol=1e-5)
        else:
            assert rel_err(tl, jl) < 1e-2


# The model of tests/test_kv_quant.py.
KVQ_CFG = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab=97, remat="none", dtype="float32")


def test_int8_decode_close_to_fp32():
    """Counterpart of tests/test_kv_quant.py's test of that name."""
    from repro_torch.models.lm import ModelConfig

    cfg = ModelConfig(**KVQ_CFG)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    p = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 24
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    logits, _ = M.forward(p, cfg, toks)
    st = M.init_state(cfgq, B, 32, device="cpu")
    _, st = M.prefill(p, cfgq, toks[:, :S - 1], st)
    ld, st = M.decode_step(p, cfgq, toks[:, S - 1:], st)
    ref = logits[:, -1]
    rel = float((ld[:, 0] - ref).abs().max() / (ref.abs().max() + 1e-6))
    assert rel < 0.05, rel
    assert st["scan"][0]["k"].dtype == torch.int8


def test_int8_cache_halves_state_bytes():
    """Counterpart of tests/test_kv_quant.py's test of that name, and the
    port's state of the same bytes as the JAX package's."""
    import math

    from repro.models.lm import ModelConfig as JModelConfig
    from repro_torch.models.lm import ModelConfig

    def nbytes(state):
        leaves = jax.tree.leaves(state) if isinstance(
            state["length"], jax.Array) else [
            v for tree in state["scan"] for v in tree.values()]
        return sum(math.prod(l.shape) * l.dtype.itemsize for l in leaves
                   if l.ndim > 1)

    for make, init_state, dtype in (
            (ModelConfig, lambda *a, **k: M.init_state(*a, device="cpu", **k),
             torch.bfloat16),
            (JModelConfig, jM.init_state, jnp.bfloat16)):
        cfg = make(**dict(KVQ_CFG, head_dim=128, dtype="bfloat16"))
        cfgq = dataclasses.replace(cfg, kv_quant=True)
        s_f = init_state(cfg, 2, 256, dtype=dtype)
        s_q = init_state(cfgq, 2, 256)
        assert nbytes(s_q) < 0.62 * nbytes(s_f)
    assert M.init_state(cfgq, 2, 256, device="cpu")["scan"][0][
        "k_scale"].shape == (3, 2, 256, 2)
