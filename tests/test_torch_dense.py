"""The port's dense decoder against the JAX package on the CPU: RoPE, the
qk-norm, the gated MLP, the attention mask and core, the whole model's
forward and decode of the four dense archs, the prepacked projections,
the configs and the parameter conversion. The KV cache's tests are in
``test_torch_dense_cache.py``.

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

from repro.configs import get_config as jget_config
from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.models.lm import attention as jA
from repro.models.lm import cache as jC
from repro.models.lm import mlp as jMLP
from repro.models.lm import model as jM
from repro.models.lm import norms as jnorms
from repro.models.lm import rope as jrope
from repro_torch.configs import get_config
from repro_torch.core import PIMQuantConfig
from repro_torch.core.packed import PackedWeight
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import cache as C
from repro_torch.models.lm import mlp as MLP
from repro_torch.models.lm import model as M
from repro_torch.models.lm import norms, rope

from _torch_parity import (DENSE_ARCHS, assert_bits_equal, assert_close,
                           check_tree_carried, dense_cfgs, dense_models,
                           normal, rel_err, t)


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


# -- RoPE, norms, MLP -----------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_apply_rope_matches_jax_to_4096(theta, head_dim):
    """Positions up to 4096, per-sequence offsets as in decode: rtol 1e-6
    (the frequencies are the JAX package's bit for bit)."""
    rng = np.random.default_rng(0)
    x = normal(rng, (2, 64, 3, head_dim))
    pos = np.stack([np.arange(64), 4032 + np.arange(64)]).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = rope.apply_rope(t(x), t(pos), theta)
    assert got.dtype == torch.float32
    assert_close(got, want, rtol=1e-6)
    js, jc = jrope.rope_angles(jnp.asarray(pos), head_dim, theta)
    ts, tc = rope.rope_angles(t(pos), head_dim, theta)
    assert_close(ts, js, rtol=1e-6)
    assert_close(tc, jc, rtol=1e-6)


def test_apply_rope_keeps_bf16():
    rng = np.random.default_rng(1)
    x = normal(rng, (1, 8, 2, 32))
    pos = np.arange(8, dtype=np.int32)[None]
    want = np.asarray(jrope.apply_rope(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(pos), 5e5), np.float32)
    got = rope.apply_rope(t(x).to(torch.bfloat16), t(pos), 5e5)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), want) < 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_head_norm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = normal(rng, (2, 5, 4, 32), 3.0)
    scale = 1 + normal(rng, (32,), 0.3)
    want = jnorms.qk_head_norm(jnp.asarray(scale),
                               jnp.asarray(x, jnp.dtype(dtype)), 1e-6)
    got = norms.qk_head_norm(t(scale), t(x).to(M.torch_dtype(dtype)), 1e-6)
    assert got.dtype == M.torch_dtype(dtype)
    if dtype == "float32":
        assert_close(got, want, rtol=1e-6)
    else:
        assert rel_err(got.float(), np.asarray(want, np.float32)) < 1e-2


@pytest.mark.parametrize("act", ["silu_gated", "gelu_gated", "gelu"])
def test_mlp_matches_jax(act):
    """Every activation of the table; ``gelu`` is the tanh approximation,
    as ``jax.nn.gelu``'s default."""
    jc, tc = dense_cfgs("llama3.2-3b", act=act)
    jp = jax.device_get(jMLP.init_mlp(jc, jax.random.PRNGKey(3)))
    x = normal(np.random.default_rng(3), (2, 7, jc.d_model), 2.0)
    want = jMLP.mlp(jp, jc, jnp.asarray(x))
    got = MLP.mlp({k: t(v) for k, v in jp.items()}, tc, t(x))
    assert sorted(MLP.init_mlp(tc, torch.Generator().manual_seed(0))) == \
        sorted(jp)
    assert_close(got, want, rtol=1e-5)


def test_mlp_gelu_is_not_the_erf_form():
    """The erf form misses the JAX package's gelu by far more than the
    tolerance above: the table would be wrong with torch's default."""
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    assert_close(MLP._ACTS["gelu"](x), want, rtol=1e-6)
    assert np.abs(torch.nn.functional.gelu(x).numpy() - want).max() > 1e-4


# -- attention core ---------------------------------------------------------------

@pytest.mark.parametrize("window,causal", [(0, True), (0, False), (5, True)])
def test_attention_mask_matches_jax(window, causal):
    q = np.stack([np.arange(4) + 6, np.arange(4)]).astype(np.int32)
    k = np.stack([np.arange(12)] * 2).astype(np.int32)
    want = jA.attention_mask(jnp.asarray(q), jnp.asarray(k), window, causal)
    got = A.attention_mask(t(q), t(k), window, causal)
    assert_bits_equal(got, want)


def _qkv(rng, b=2, sq=5, skv=9, hq=6, hkv=2, d=16):
    return (normal(rng, (b, sq, hq, d)), normal(rng, (b, skv, hkv, d)),
            normal(rng, (b, skv, hkv, d)))


def _mask(b, sq, skv, full_row=None):
    q = np.arange(sq)[None] + (skv - sq)
    m = np.broadcast_to(np.arange(skv)[None, None] <= q[..., None],
                        (b, sq, skv)).copy()
    if full_row is not None:
        m[full_row] = False
    return m[:, None]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_gqa_core_float32_matches_jax(softcap):
    """Query head h reads KV head h // G (G = 3 here)."""
    q, k, v = _qkv(np.random.default_rng(4))
    m = _mask(2, 5, 9)
    want = jA.gqa_scores_softmax_v(*map(jnp.asarray, (q, k, v, m)),
                                   softcap=softcap)
    got = A.gqa_scores_softmax_v(*map(t, (q, k, v, m)), softcap=softcap)
    assert_close(got, want, rtol=1e-5)


def test_gqa_core_heads_read_their_group():
    """Zeroing KV head 1 changes exactly query heads 3-5 (G = 3)."""
    q, k, v = _qkv(np.random.default_rng(5))
    m = t(_mask(2, 5, 9))
    base = A.gqa_scores_softmax_v(t(q), t(k), t(v), m)
    v2 = v.copy()
    v2[:, :, 1] = 0
    moved = (A.gqa_scores_softmax_v(t(q), t(k), t(v2), m) - base).abs().amax(
        dim=(0, 1, 3))
    assert (moved[:3] == 0).all() and (moved[3:] > 0).all()


def test_gqa_core_bf16_close_to_jax():
    """bf16 operands: the scores and PV in float32 on the bf16-rounded
    operands, as the JAX package contracts them; within 1e-2."""
    q, k, v = _qkv(np.random.default_rng(6))
    m = _mask(2, 5, 9)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jA.gqa_scores_softmax_v(*jb, jnp.asarray(m))
    tb = [t(x).to(torch.bfloat16) for x in (q, k, v)]
    got = A.gqa_scores_softmax_v(*tb, t(m))
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) < 1e-2


def test_gqa_core_int8_kv_with_scales_matches_jax():
    """int8 k/v with per-(token, head) scales folded into the scores and
    the probabilities; q stays float."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng)
    kq, ks = jC.quantize_kv(jnp.asarray(k))
    vq, vs = jC.quantize_kv(jnp.asarray(v))
    m = _mask(2, 5, 9)
    want = jA.gqa_scores_softmax_v(jnp.asarray(q), kq, vq, jnp.asarray(m),
                                   k_scale=ks, v_scale=vs)
    got = A.gqa_scores_softmax_v(t(q), t(kq), t(vq), t(m), k_scale=t(ks),
                                 v_scale=t(vs))
    assert_close(got, want, rtol=1e-5)


def test_gqa_core_fully_masked_row_is_uniform():
    """A row with nothing to attend gets NEG everywhere: a uniform softmax
    (the mean of v), not NaN, as in the JAX package."""
    q, k, v = _qkv(np.random.default_rng(8))
    m = _mask(2, 5, 9, full_row=(1, 2))
    want = jA.gqa_scores_softmax_v(*map(jnp.asarray, (q, k, v, m)))
    got = A.gqa_scores_softmax_v(*map(t, (q, k, v, m)))
    assert torch.isfinite(got).all()
    assert_close(got, want, rtol=1e-5)
    mean_v = torch.from_numpy(v[1]).mean(0).repeat_interleave(3, dim=0)
    assert torch.allclose(got[1, 2], mean_v, atol=1e-6)


def test_attention_later_kinds_raise():
    """Cross-attention runs on ``kv_src`` (``tests/test_torch_cross_attn.py``
    holds it against the JAX package), and a ``cross_attn`` block without
    image embeddings raises ``ValueError``; the ring branch of local
    attention runs (``tests/test_torch_ring_cache.py``)."""
    jc, tc = dense_cfgs("llama3.2-3b")
    p = A.init_attention(tc, torch.Generator().manual_seed(0))
    x = torch.zeros((1, 2, tc.d_model))
    pos = torch.zeros((1, 2), dtype=torch.int32)
    out, none = A.attention(p, tc, x, pos, kv_src=torch.ones(1, 5, tc.d_model))
    assert out.shape == x.shape and none is None
    blk = M.init_block("cross_attn", tc, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="image_embeds"):
        M.apply_block("cross_attn", blk, tc, x, pos)
    ring = C.init_ring_cache(tc, 1, 4, dtype=torch.float32)
    out, got = A.attention(p, tc, x, pos, cache=ring,
                           cache_index=torch.zeros(1, dtype=torch.int32),
                           window=4, ring=True)
    assert got is ring and out.shape == x.shape


# -- whole model ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_match_jax(dense, arch):
    """Each dense arch, reduced, float32: forward logits within rtol 1e-5
    (atol floor 1e-5 * max)."""
    d = dense[arch]
    toks = np.random.default_rng(14).integers(0, d["jc"].vocab, (2, 20)).astype(np.int32)
    want, _ = jM.forward(d["jp"], d["jc"], jnp.asarray(toks))
    got, aux = M.forward(d["tp"], d["tc"], t(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert_close(got, want, rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_forward(dense, arch):
    """Counterpart of tests/test_models_lm.py's test of that name:
    prefill(S-1) + decode(1) logits against forward(S)'s last position;
    the port's decode also against the JAX package's decode."""
    d = dense[arch]
    S = 16
    toks = np.random.default_rng(15).integers(0, d["jc"].vocab, (2, S)).astype(np.int32)
    logits, _ = M.forward(d["tp"], d["tc"], t(toks))
    st = M.init_state(d["tc"], 2, S + 8, device="cpu")
    _, st = M.prefill(d["tp"], d["tc"], t(toks[:, :S - 1]), st)
    ld, st = M.decode_step(d["tp"], d["tc"], t(toks[:, S - 1:]), st)
    assert st["length"].tolist() == [S, S]
    assert_close(ld[:, 0], logits[:, -1], rtol=1e-4)
    jst = jM.init_state(d["jc"], 2, S + 8)
    _, jst = jM.prefill(d["jp"], d["jc"], jnp.asarray(toks[:, :S - 1]), jst)
    jld, _ = jM.decode_step(d["jp"], d["jc"], jnp.asarray(toks[:, S - 1:]),
                            jst)
    assert_close(ld, jld, rtol=1e-5)


def test_bf16_forward_close_to_jax(dense):
    """bf16 parameters (``cast_params``) and a bf16 KV path: logits within
    10% of the largest and the last position's greedy token equal (bf16
    rounds at other places in the two frameworks; ``ROADMAP.md`` Queue 3)."""
    d = dense["llama3.2-3b"]
    jc, tc = (dataclasses.replace(c, dtype="bfloat16")
              for c in (d["jc"], d["tc"]))
    toks = np.random.default_rng(18).integers(0, jc.vocab, (2, 16)).astype(np.int32)
    want, _ = jM.forward(jM.cast_params(d["jp"], jnp.bfloat16), jc,
                         jnp.asarray(toks))
    got, _ = M.forward(M.cast_params(d["tp"], torch.bfloat16), tc, t(toks))
    assert rel_err(got, want) < 1e-1
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  np.asarray(want)[:, -1].argmax(-1))


# -- prepack, configs, conversion -----------------------------------------------------

def test_prepack_params_packs_the_leaves_jax_packs(dense):
    """The same set of leaves is prepacked in both packages (attention,
    MLP; the tied embedding stays float), with equal codes."""
    d = dense["qwen1.5-4b"]
    jpim = JPIMQuantConfig(8, 8, backend="int-direct")
    jpk = jM.prepack_params(d["jp"], jpim)
    tpk = M.prepack_params(d["tp"], PIMQuantConfig(8, 8, backend="int-direct"))

    def packed_paths(tree, is_packed, path=()):
        if is_packed(tree):
            return {path}
        if isinstance(tree, dict):
            return set().union(*[packed_paths(v, is_packed, path + (k,))
                                 for k, v in tree.items()])
        if isinstance(tree, list) and tree and not is_packed(tree[0]):
            return set().union(*[packed_paths(v, is_packed, path + (i,))
                                 for i, v in enumerate(tree)])
        if isinstance(tree, list) and tree:
            return {path}
        return set()

    from repro.core.packed import PackedWeight as JPackedWeight

    want = packed_paths(jpk, lambda x: isinstance(x, JPackedWeight))
    got = packed_paths(tpk, lambda x: isinstance(x, PackedWeight))
    assert got == want
    assert {p[-1] for p in got} == {"wq", "wk", "wv", "wo", "w_in", "w_out",
                                    "w_gate", "head"}   # qwen1.5: untied
    jw = jpk["scan"][0]["attn"]["wq"]
    for r, pw in enumerate(tpk["scan"][0]["attn"]["wq"]):
        assert_bits_equal(pw.codes32, np.asarray(jw.codes)[r])
    assert isinstance(tpk["embed"], torch.Tensor)     # the gather: float


def test_pim_proj_keys_are_the_references_ported_kinds():
    """The reference's set, the rglru input projection ``w_x`` included."""
    assert M._PIM_PROJ_KEYS == jM._PIM_PROJ_KEYS


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_match_jax(arch):
    jarch, tarch = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(tarch.model) == dataclasses.asdict(jarch.model)
    assert dataclasses.asdict(tarch.model.reduced()) == dataclasses.asdict(
        jarch.model.reduced())
    assert (tarch.arch_id, tarch.source, tarch.notes) == (
        jarch.arch_id, jarch.source, jarch.notes)
    assert tarch.model.n_params() == jarch.model.n_params()
    assert M.layer_plan(tarch.model) == jM.layer_plan(jarch.model)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-4b"])
def test_params_from_jax_carries_the_dense_tree(dense, arch):
    """Stacked scan leaves, the QKV biases, the qk-norm scales and the
    (tied) embedding arrive, in the shapes of the port's own init."""
    d = dense[arch]
    own = M.init(d["tc"], torch.Generator().manual_seed(0), device="cpu")
    check_tree_carried(d["jp"], d["tp"], own)
    attn = d["tp"]["scan"][0]["attn"]
    assert ("bq" in attn) == d["tc"].qkv_bias
    assert ("q_norm" in attn) == d["tc"].qk_norm
    assert ("head" not in d["tp"]) == d["tc"].tie_embeddings


def test_moe_and_later_block_kinds_raise():
    """An MoE FFN builds in every FFN block kind (ported with grok-1 and
    phi3.5-moe), the cross-attention's too, as the JAX package builds it;
    a kind the JAX package does not have raises ``ValueError``."""
    jc, tc = dense_cfgs("llama3.2-3b")
    from repro_torch.models.lm import MoEConfig

    moe = dataclasses.replace(tc, moe=MoEConfig(n_experts=4, top_k=2))
    for kind in ("attn", "local_attn", "rglru", "cross_attn"):
        moe_k = dataclasses.replace(moe, block_pattern=(kind,))
        p = M.init(moe_k, torch.Generator().manual_seed(0), device="cpu")
        ffn = p["scan"][0]["ffn"]
        assert ffn["router"].shape == (moe_k.n_layers, tc.d_model, 4)
        assert ffn["w_in"].shape == (moe_k.n_layers, 4, tc.d_model, tc.d_ff)
    cross = dataclasses.replace(tc, block_pattern=("cross_attn",),
                                n_image_tokens=6)
    st = M.init_state(cross, 1, 8, device="cpu")
    assert st["scan"][0]["k"].shape[:3] == (cross.n_layers, 1, 6)
    other = dataclasses.replace(tc, block_pattern=("mamba",))
    with pytest.raises(ValueError, match="mamba"):
        M.init_state(other, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        M.init(other, torch.Generator().manual_seed(0), device="cpu")
