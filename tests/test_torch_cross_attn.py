"""The port's cross-attention (the ``cross_attn`` block kind of
llama-3.2-vision-90b) against the JAX package on the CPU: the attention
with ``kv_src`` with and without its image cache, the write of the image
keys and values at ``cache_index == 0`` only, the float cross cache under
``kv_quant``, the gate, the whole model's forward, prefill and decode step
in float32, bf16 and <8:8>, the config, the parameter conversion and the
refusals.

Inputs are made with numpy from a seed and given to both packages. The
model is the arch's ``reduced()`` width (blocks attn, attn, cross_attn
twice; 16 image tokens) with every cross gate set non-zero in both trees:
the gate is 0 at init, and tanh(0) would zero the branch under test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.core.packed import PackedWeight as JPackedWeight
from repro.models.lm import attention as jA
from repro.models.lm import cache as jC
from repro.models.lm import model as jM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import PIMQuantConfig
from repro_torch.core.packed import PackedWeight
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import cache as C
from repro_torch.models.lm import model as M
from repro_torch.serving import ServeEngine

from _torch_parity import (assert_close, normal, rel_err, stub_cfgs,
                           stub_params, t)

VISION = "llama-3.2-vision-90b"
S = 12


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def vision():
    """Reduced llama-3.2-vision-90b in float32, one set of weights (gates
    0.7 and 0.8) in both packages, two prompts of ``S`` tokens and their
    image embeddings."""
    jc, tc = stub_cfgs(VISION)
    jp, tp = stub_params(jc)
    rng = np.random.default_rng(30)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp,
                toks=rng.integers(0, jc.vocab, (2, S)).astype(np.int32),
                img=normal(rng, (2, jc.n_image_tokens, jc.d_model), 0.1))


def _attention_params(jc, seed=0, gate=0.7):
    """One cross-attention's weights from the JAX init, gate set to
    ``gate``, in both packages."""
    jp = jax.device_get(jA.init_attention(jc, jax.random.PRNGKey(seed),
                                          cross=True))
    jp["gate"] = np.float32(gate)
    return jp, convert.params_from_jax(jp)


def _as(x, dtype):
    """numpy float32 -> (JAX array, torch tensor), both in ``dtype``."""
    j = jnp.asarray(x).astype(jnp.dtype(dtype))
    return j, t(x).to(M.torch_dtype(dtype))


def _greedy(pkg, cfg, params, toks, img, n_steps, eager=False):
    """Prefill ``toks`` then ``n_steps`` greedy decode steps, the same
    image at every call, through ``pkg`` (``jM`` or ``M``). Returns the
    logits of the prefill and of each step, as numpy."""
    if pkg is jM:
        conv, state = jnp.asarray, jM.init_state(cfg, toks.shape[0], 32)
        img = jnp.asarray(img)
    else:
        conv, state = t, M.init_state(cfg, toks.shape[0], 32, device="cpu")
        img = t(img) if isinstance(img, np.ndarray) else img
    ctx = jax.disable_jit() if eager else torch.no_grad()
    out = []
    with ctx:
        p = pkg.prepack_params(params, cfg.pim) if cfg.pim else params
        lo, state = pkg.prefill(p, cfg, conv(toks), state, image_embeds=img)
        out.append(np.asarray(lo, np.float32))
        for _ in range(n_steps):
            nxt = out[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
            lo, state = pkg.decode_step(p, cfg, conv(nxt), state,
                                        image_embeds=img)
            out.append(np.asarray(lo, np.float32))
    return out


# -- config, init, conversion ------------------------------------------------------

def test_vision_config_matches_jax():
    """The published config, its reduced form, the merged layer list (one
    cross layer after every 4 self layers) and the unit: the JAX
    package's."""
    jarch, tarch = jget_config(VISION), get_config(VISION)
    assert dataclasses.asdict(tarch.model) == dataclasses.asdict(jarch.model)
    assert (tarch.arch_id, tarch.source, tarch.notes) == (
        jarch.arch_id, jarch.source, jarch.notes)
    m = tarch.model
    assert (m.n_layers, m.d_model, m.n_heads, m.n_kv_heads, m.head_dim,
            m.d_ff, m.vocab, m.act, m.cross_attn_every, m.n_image_tokens,
            m.rope_theta, m.tie_embeddings) == (
        100, 8192, 64, 8, 128, 28672, 128_256, "silu_gated", 4, 6400,
        500_000.0, False)
    assert dataclasses.asdict(m.reduced()) == dataclasses.asdict(
        jarch.model.reduced())
    assert M.layer_plan(m) == jM.layer_plan(jarch.model) == (
        ("attn",) * 4 + ("cross_attn",), 20, ())
    unit = dataclasses.replace(m, n_layers=5)
    assert unit.blocks == ("attn",) * 4 + ("cross_attn",)
    assert unit.n_params() == dataclasses.replace(
        jarch.model, n_layers=5).n_params()


def test_init_tree_matches_jax_tree(vision):
    """The port's init has the JAX init's tree: every leaf's shape, a
    zero 0-d float32 gate per cross layer (stacked (reps,)), and the JAX
    package's parameter count (which ``n_params`` undercounts by the cross
    blocks' FFNs)."""
    jc, tc = vision["jc"], vision["tc"]
    own = M.init(tc, torch.Generator().manual_seed(0), device="cpu")
    fresh = jax.device_get(jax.jit(jM.init, static_argnums=0)(
        jc, jax.random.PRNGKey(0)))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(own) == shapes(fresh)
    gate = own["scan"][2]["attn"]["gate"]
    assert gate.dtype == torch.float32 and gate.shape == (2,)
    assert not gate.any()
    assert "gate" not in own["scan"][0]["attn"]
    assert "ffn" in own["scan"][2]
    count = sum(x.numel() for x in jax.tree.leaves(
        own, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert count == jM.param_count(jc)
    assert count > jc.n_params()


def test_params_from_jax_carries_the_gate_leaves(vision):
    """The (reps,) float32 gates arrive as float32 tensors with their
    values; ``cast_params`` keeps them float32 in both packages (ndim 1
    under the stack) and ``prepack_params`` leaves them unpacked, as the
    JAX package does."""
    jp, tp = vision["jp"], vision["tp"]
    g = tp["scan"][2]["attn"]["gate"]
    assert g.dtype == torch.float32 and tuple(g.shape) == (2,)
    np.testing.assert_array_equal(g.numpy(), jp["scan"][2]["attn"]["gate"])
    np.testing.assert_allclose(g.numpy(), [0.7, 0.8], rtol=1e-6)
    jb = jax.device_get(jM.cast_params(jp, jnp.bfloat16))
    tb = M.cast_params(tp, torch.bfloat16)
    assert jb["scan"][2]["attn"]["gate"].dtype == np.float32
    assert tb["scan"][2]["attn"]["gate"].dtype == torch.float32
    assert convert.params_from_jax(jb)["scan"][2]["attn"]["gate"].dtype \
        == torch.float32
    assert tb["scan"][2]["attn"]["wk"].dtype == torch.bfloat16
    jpk = jM.prepack_params(jp, JPIMQuantConfig(8, 8, backend="int-direct"))
    tpk = M.prepack_params(tp, PIMQuantConfig(8, 8, backend="int-direct"))
    for j, p in zip(jpk["scan"], tpk["scan"]):
        assert set(j["attn"]) == set(p["attn"])
        for k, v in p["attn"].items():
            assert isinstance(j["attn"][k], JPackedWeight) == isinstance(
                v, list) and (not isinstance(v, list)
                              or isinstance(v[0], PackedWeight))
    assert isinstance(tpk["scan"][2]["attn"]["gate"], torch.Tensor)
    assert isinstance(tpk["head"], PackedWeight)


# -- the attention ---------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_attention_kv_src_without_cache_matches_jax(vision, kv_dtype):
    """Keys and values from the image, no RoPE, every query on every image
    token, the gated output: float32 within 1e-5; image embeddings in bf16
    on the float32 model (the projections then run in bf16, in both
    packages) within 1e-2."""
    jc, tc = vision["jc"], vision["tc"]
    jp, tp = _attention_params(jc)
    rng = np.random.default_rng(31)
    x = normal(rng, (2, 5, jc.d_model))
    pos = np.tile(np.arange(3, 8, dtype=np.int32), (2, 1))
    jimg, timg = _as(normal(rng, (2, 16, jc.d_model), 0.1), kv_dtype)
    want, jcache = jA.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                kv_src=jimg)
    got, cache = A.attention(tp, tc, t(x), t(pos), kv_src=timg)
    assert jcache is None and cache is None
    assert got.dtype == torch.float32
    if kv_dtype == "float32":
        assert_close(got, want, rtol=1e-5)
    else:
        assert rel_err(got, want) < 1e-2


def test_attention_init_adds_a_zero_gate():
    """``init_attention(cross=True)``: the JAX package's keys and shapes,
    a 0-d float32 gate at 0; a self-attention has none."""
    jc, tc = stub_cfgs(VISION)
    own = A.init_attention(tc, torch.Generator().manual_seed(0), cross=True)
    ref = jA.init_attention(jc, jax.random.PRNGKey(0), cross=True)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert own["gate"].dtype == torch.float32 and float(own["gate"]) == 0.0
    assert "gate" not in A.init_attention(tc, torch.Generator().manual_seed(0))


def test_gate_scales_the_branch(vision):
    """The branch's output is tanh(gate) times the ungated one: zero at
    init's gate, and the 0.7 gate moves it (in both packages alike)."""
    jc, tc = vision["jc"], vision["tc"]
    rng = np.random.default_rng(32)
    x, img = normal(rng, (2, 3, jc.d_model)), normal(rng, (2, 16, jc.d_model))
    pos = np.zeros((2, 3), np.int32)
    outs = {}
    for g in (0.0, 0.7):
        jp, tp = _attention_params(jc, gate=g)
        outs[g], _ = A.attention(tp, tc, t(x), t(pos), kv_src=t(img))
        want, _ = jA.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                               kv_src=jnp.asarray(img))
        assert_close(outs[g], want, rtol=1e-5)
    assert not outs[0.0].any()
    assert float(outs[0.7].abs().max()) > 1e-3
    ungated = {k: v for k, v in tp.items() if k != "gate"}
    plain, _ = A.attention(ungated, tc, t(x), t(pos), kv_src=t(img))
    torch.testing.assert_close(outs[0.7], np.tanh(0.7) * plain, rtol=1e-5,
                               atol=1e-6)


def test_cross_cache_written_at_index_zero_only(vision):
    """A cache call at ``cache_index`` 0 writes the image keys and values
    (in place); a second call with other image embeddings writes only the
    rows whose index is 0, and every other row attends to its cached
    image, as in the JAX package (outputs within 1e-5)."""
    jc, tc = vision["jc"], vision["tc"]
    jp, tp = _attention_params(jc, seed=1)
    rng = np.random.default_rng(33)
    cache = C.init_kv_cache(tc, 2, 16, dtype=torch.float32)
    jcache = jC.init_kv_cache(jc, 2, 16, dtype=jnp.float32)
    img_a, img_b = (normal(rng, (2, 16, jc.d_model), 0.1) for _ in range(2))
    steps = [(np.array([0, 0], np.int32), img_a, 4),
             (np.array([4, 0], np.int32), img_b, 1)]
    for idx, img, sq in steps:
        x = normal(rng, (2, sq, jc.d_model))
        pos = idx[:, None] + np.arange(sq, dtype=np.int32)[None]
        want, jcache = jA.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                    kv_src=jnp.asarray(img), cache=jcache,
                                    cache_index=jnp.asarray(idx))
        got, same = A.attention(tp, tc, t(x), t(pos), kv_src=t(img),
                                cache=cache, cache_index=t(idx))
        assert same is cache
        assert_close(got, want, rtol=1e-5)
        np.testing.assert_allclose(cache["k"].numpy(), jcache["k"],
                                   rtol=1e-5, atol=1e-6)
    k_a = (t(img_a) @ tp["wk"]).reshape(2, 16, tc.n_kv_heads, tc.head_dim)
    k_b = (t(img_b) @ tp["wk"]).reshape(2, 16, tc.n_kv_heads, tc.head_dim)
    torch.testing.assert_close(cache["k"][0], k_a[0])   # kept
    torch.testing.assert_close(cache["k"][1], k_b[1])   # rewritten


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cross_cache_stays_float(kv_quant):
    """``init_layer_state("cross_attn")``: ``n_image_tokens`` rows (or the
    config's) of float keys and values, even under ``kv_quant``; the model
    state stacks it over the unit's reps with the JAX package's shapes and
    dtypes (its self layers int8 under ``kv_quant``)."""
    jc, tc = stub_cfgs(VISION, kv_quant=kv_quant)
    st = C.init_layer_state("cross_attn", tc, 3, 40, device="cpu",
                            dtype=torch.bfloat16)
    assert set(st) == {"k", "v"} and st["k"].dtype == torch.bfloat16
    assert st["k"].shape == (3, 16, tc.n_kv_heads, tc.head_dim)
    assert C.init_layer_state("cross_attn", tc, 1, 40, dtype=torch.float32,
                              n_image_tokens=7)["v"].shape[1] == 7
    own = M.init_state(tc, 2, 24, device="cpu", dtype=torch.float32)
    ref = jM.init_state(jc, 2, 24, dtype=jnp.float32)
    for o, r in zip(own["scan"], ref["scan"]):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in o.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in r.items()}
    assert own["scan"][2]["k"].shape == (2, 2, 16, tc.n_kv_heads,
                                         tc.head_dim)
    assert (own["scan"][0]["k"].dtype == torch.int8) == kv_quant


# -- the whole model ------------------------------------------------------------

def test_forward_matches_jax(vision):
    """Float32 forward logits within rtol 1e-5 of the JAX package's, and
    the cross branch moves them (gates set to 0 give other logits)."""
    d = vision
    want, _ = jM.forward(d["jp"], d["jc"], jnp.asarray(d["toks"]),
                         image_embeds=jnp.asarray(d["img"]))
    got, aux = M.forward(d["tp"], d["tc"], t(d["toks"]),
                         image_embeds=t(d["img"]))
    assert got.shape == (2, S, d["tc"].vocab) and float(aux) == 0.0
    assert_close(got, want, rtol=1e-5)
    closed = M._map(lambda x: x, d["tp"])
    for blk in closed["scan"]:
        if "gate" in blk["attn"]:
            blk["attn"]["gate"] = torch.zeros_like(blk["attn"]["gate"])
    shut, _ = M.forward(closed, d["tc"], t(d["toks"]),
                        image_embeds=t(d["img"]))
    assert rel_err(shut, got) > 1e-2


def test_prefill_and_decode_match_jax(vision):
    """prefill(S - 1) then three decode steps, the same image at every
    call: each call's logits within 1e-5 of the JAX package's, and the
    first step's within 1e-4 of forward's last position."""
    d = vision
    got = _greedy(M, d["tc"], d["tp"], d["toks"][:, :S - 1], d["img"], 3)
    want = _greedy(jM, d["jc"], d["jp"], d["toks"][:, :S - 1], d["img"], 3)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-5)
    full, _ = M.forward(d["tp"], d["tc"], t(d["toks"]),
                        image_embeds=t(d["img"]))
    st = M.init_state(d["tc"], 2, 32, device="cpu")
    _, st = M.prefill(d["tp"], d["tc"], t(d["toks"][:, :S - 1]), st,
                      image_embeds=t(d["img"]))
    lo, st = M.decode_step(d["tp"], d["tc"], t(d["toks"][:, S - 1:]), st,
                           image_embeds=t(d["img"]))
    assert st["length"].tolist() == [S, S]
    assert_close(lo[:, 0], full[:, -1], rtol=1e-4)


def test_bf16_forward_and_decode_close_to_jax(vision):
    """bf16 weights (``cast_params``) and bf16 image embeddings: forward
    and decode logits within 10% of the largest and the last position's
    greedy token equal (bf16 rounds at other places in the two
    frameworks; ``ROADMAP.md`` Queue 3)."""
    d = vision
    jc, tc = (dataclasses.replace(c, dtype="bfloat16")
              for c in (d["jc"], d["tc"]))
    jp = jM.cast_params(d["jp"], jnp.bfloat16)
    tp = M.cast_params(d["tp"], torch.bfloat16)
    jimg, timg = _as(d["img"], "bfloat16")
    want, _ = jM.forward(jp, jc, jnp.asarray(d["toks"]), image_embeds=jimg)
    got, _ = M.forward(tp, tc, t(d["toks"]), image_embeds=timg)
    assert rel_err(got, want) < 1e-1
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  np.asarray(want)[:, -1].argmax(-1))
    st = M.init_state(tc, 2, 32, device="cpu")
    jst = jM.init_state(jc, 2, 32)
    _, st = M.prefill(tp, tc, t(d["toks"][:, :S - 1]), st, image_embeds=timg)
    _, jst = jM.prefill(jp, jc, jnp.asarray(d["toks"][:, :S - 1]), jst,
                        image_embeds=jimg)
    assert st["scan"][2]["k"].dtype == torch.bfloat16
    lo, _ = M.decode_step(tp, tc, t(d["toks"][:, S - 1:]), st,
                          image_embeds=timg)
    jlo, _ = jM.decode_step(jp, jc, jnp.asarray(d["toks"][:, S - 1:]), jst,
                            image_embeds=jimg)
    assert rel_err(lo, jlo) < 1e-1
    np.testing.assert_array_equal(lo.numpy()[:, -1].argmax(-1),
                                  np.asarray(jlo)[:, -1].argmax(-1))


@pytest.mark.parametrize("img_dtype", ["float32", "bfloat16"])
def test_pim_greedy_tokens_equal_eager_jax(img_dtype):
    """<8:8>, two layers (attn, then cross_attn: ``n_layers=2,
    cross_attn_every=1``), every projection prepacked and the head too:
    the port on the ``cuda`` backend (kernels 1-2's plain versions here)
    gives the greedy tokens of the JAX package run op by op on int-direct,
    over a prefill and four decode steps, with the image embeddings in
    float32 and in bf16 (the cross ``wk``/``wv`` then quantize bf16
    activations and return bf16, in both packages). The logits agree
    within 0.1 of the largest: the path is chaotic (a float ulp flips an
    activation code, which moves the logits by ~1%, as on one dense
    layer; ``ROADMAP.md`` Queue 3)."""
    jc, tc = stub_cfgs(VISION, n_layers=2, cross_attn_every=1)
    assert tc.blocks == ("attn", "cross_attn")
    jp, tp = stub_params(jc, seed=2)
    jc = dataclasses.replace(jc, pim=JPIMQuantConfig(8, 8,
                                                     backend="int-direct"))
    tc = dataclasses.replace(tc, pim=PIMQuantConfig(8, 8, backend="cuda"))
    rng = np.random.default_rng(34)
    toks = rng.integers(0, jc.vocab, (2, 9)).astype(np.int32)
    img = normal(rng, (2, jc.n_image_tokens, jc.d_model), 0.1)
    jimg, timg = _as(img, img_dtype)
    got = _greedy(M, tc, tp, toks, timg, 4)
    want = _greedy(jM, jc, jp, toks, jimg, 4, eager=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:, -1].argmax(-1),
                                      w[:, -1].argmax(-1))
        assert rel_err(g, w) < 1e-1


def test_missing_image_embeds_raises(vision):
    """Without ``image_embeds`` a cross block raises ``ValueError`` in
    ``forward``, ``prefill`` and ``decode_step`` (the JAX package would run
    it as self-attention over its image cache; ``ROADMAP.md`` Queue 3)."""
    d = vision
    st = M.init_state(d["tc"], 2, 32, device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        M.forward(d["tp"], d["tc"], t(d["toks"]))
    with pytest.raises(ValueError, match="image_embeds"):
        M.prefill(d["tp"], d["tc"], t(d["toks"]), st)
    _, st = M.prefill(d["tp"], d["tc"], t(d["toks"]), st,
                      image_embeds=t(d["img"]))
    with pytest.raises(ValueError, match="image_embeds"):
        M.decode_step(d["tp"], d["tc"], t(d["toks"][:, :1]), st)
    with pytest.raises(ValueError, match="mamba"):
        M.init_block("mamba", d["tc"], torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["musicgen-large", VISION])
def test_serve_engine_refuses_stub_frontend_archs(arch):
    """The engine serves token-in archs: these two are driven through
    ``prefill`` and ``decode_step``, as in the JAX package."""
    _, tc = stub_cfgs(arch)
    params = M.init(tc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="token-in"):
        ServeEngine(tc, params, device="cpu")
