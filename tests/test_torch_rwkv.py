"""The port's RWKV-6 stack against the JAX package on the CPU: the chunked
WKV (kernel 5's plain versions), the time-mix and channel-mix halves, the
whole model's forward, prefill and decode step, the prepacked planes, the
configs and the parameter conversion.

Inputs are made with numpy from a seed and given to both packages; the
model runs at ``rwkv6-3b``'s ``reduced()`` width in float32 (bf16 rounds at
other places in the two frameworks; one test checks bf16 loosely). The JAX
side runs op by op (``jax.disable_jit``) where a test says "eager".
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.kernels import ref as jref
from repro.kernels.rwkv_chunk import wkv_chunked as jwkv_chunked
from repro.models.lm import model as jM
from repro.models.lm import norms as jnorms
from repro.models.lm import rwkv6 as jRW
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import PIMQuantConfig
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_chunk as K
from repro_torch.models.lm import model as M
from repro_torch.models.lm import norms
from repro_torch.models.lm import rwkv6 as RW

from _torch_parity import assert_bits_equal, n, t


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    the reference's wall-clock tests share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# The reference test's sweep (tests/test_kernels.py): (bh, s, d, chunk).
WKV_CASES = [(2, 32, 8, 8), (6, 64, 16, 16), (1, 48, 32, 16), (4, 128, 16, 32)]


def _cfgs(**kw):
    jc = dataclasses.replace(jget_config("rwkv6-3b").model.reduced(),
                             dtype="float32", **kw)
    tc = dataclasses.replace(get_config("rwkv6-3b").model.reduced(),
                             dtype="float32", **kw)
    return jc, tc


def _wkv_inputs(bh, s, d, seed):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32) * 0.5
               for _ in range(3))
    lw = np.maximum(-np.exp(rng.standard_normal((bh, s, d)) - 2),
                    -5.0).astype(np.float32)
    u = (rng.standard_normal((bh, d)) * 0.2).astype(np.float32)
    s0 = (rng.standard_normal((bh, d, d)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, s0


def _rel(got, want):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _abs(got, want):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max())


# -- kernel 5's plain versions ------------------------------------------------

@pytest.mark.parametrize("bh,s,d,chunk", WKV_CASES)
def test_wkv_plain_matches_pallas_and_scan_oracle(bh, s, d, chunk):
    """The plain chunked WKV (what the wrapper runs on a CPU tensor)
    against the Pallas kernel in interpret mode and the sequential scan,
    at the reference test's tolerances: y relative 1e-4, state absolute
    1e-3. The port's scan equals the JAX scan to the same bounds."""
    a = _wkv_inputs(bh, s, d, seed=bh * 1000 + s)
    y_pl, s_pl = jwkv_chunked(*map(jnp.asarray, a), chunk=chunk,
                              interpret=True)
    y_ref, s_ref = jref.wkv_chunked_ref(*map(jnp.asarray, a))
    ta = [t(x) for x in a]
    before = ops.launch_counts()["wkv_chunked"]
    y, s_fin = ops.wkv_chunked(*ta, chunk=chunk)
    assert ops.launch_counts()["wkv_chunked"] == before   # CPU: no launch
    for y_want, s_want in ((y_pl, s_pl), (y_ref, s_ref)):
        assert _rel(y, y_want) < 1e-4
        assert _abs(s_fin, s_want) < 1e-3
    y_scan, s_scan = K.wkv_chunked_ref(*ta)
    assert _rel(y_scan, y_ref) < 1e-4
    assert _abs(s_scan, s_ref) < 1e-3


@pytest.mark.parametrize("bh,s,d,chunk", WKV_CASES)
def test_model_chunked_wkv_matches_jax_tightly(bh, s, d, chunk):
    """``rwkv6._chunked_wkv`` (log decay, head layout, the wrapper) against
    the JAX ``_chunked_wkv`` on (1, S, H, D) inputs: the same float32
    algebra, so within 1e-5 (y relative, state absolute), ten times tighter
    than the kernel tolerances (measured: below 1e-6)."""
    r, k, v, lw, u, s0 = _wkv_inputs(bh, s, d, seed=7 + s)

    def bshd(x):  # (BH, S, D) -> (1, S, H=BH, D)
        return np.ascontiguousarray(x[None].transpose(0, 2, 1, 3))

    w = np.exp(lw)
    jy, js = jRW._chunked_wkv(*(jnp.asarray(bshd(x)) for x in (r, k, v, w)),
                              jnp.asarray(u), jnp.asarray(s0[None]), chunk)
    ty, ts = RW._chunked_wkv(*(t(bshd(x)) for x in (r, k, v, w)), t(u),
                             t(s0[None]), chunk)
    assert _rel(ty, jy) < 1e-5
    assert _abs(ts, js) < 1e-5


@pytest.mark.parametrize("shape,chunk,match", [
    ((2, 32, 48), 16, "head dim"), ((2, 36, 16), 12, "chunk"),
    ((2, 40, 16), 16, "multiple"), ((2, 0, 16), 16, "multiple")])
def test_wkv_wrapper_rejects_what_the_kernel_does_not_take(shape, chunk,
                                                           match):
    bh, s, d = shape
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        ops.wkv_chunked(x, x, x, x, torch.zeros((bh, d)),
                        torch.zeros((bh, d, d)), chunk=chunk)


def test_wkv_wrapper_rejects_other_types_and_shapes():
    x = torch.zeros((2, 16, 16))
    u, s0 = torch.zeros((2, 16)), torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="float32"):
        ops.wkv_chunked(x.double(), x, x, x, u, s0, chunk=16)
    with pytest.raises(ValueError, match="s0"):
        ops.wkv_chunked(x, x, x, x, u, s0[:, :8], chunk=16)
    m = x.to("meta")
    with pytest.raises(ValueError, match="device"):
        ops.wkv_chunked(m, m, m, m, u.to("meta"), s0.to("meta"), chunk=16)


# -- the block halves -----------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    """The reduced rwkv6-3b (float32) in both packages, one set of weights
    (JAX init from PRNGKey(0), carried across), with a nonzero bonus u."""
    jc, tc = _cfgs()
    jp = jax.device_get(jM.init(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for blk in jp["scan"]:
        tm = blk["time_mix"]
        tm["u"] = (rng.standard_normal(tm["u"].shape) * 0.3).astype(
            np.float32)
    return dict(jc=jc, tc=tc, jp=jp, tp=convert.params_from_jax(jp))


def _block_state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"tm_shift": rng.standard_normal((b, cfg.d_model)).astype(
                np.float32),
            "cm_shift": rng.standard_normal((b, cfg.d_model)).astype(
                np.float32),
            "wkv": (rng.standard_normal((b, h, hd, hd)) * 0.1).astype(
                np.float32)}


@pytest.mark.parametrize("s", [32, 16, 5, 1])
def test_time_and_channel_mix_with_state_match_eager_jax(reduced, s):
    """Both halves of rep 1's block with a carried state, eager: the
    chunked WKV (s = 16, 32), the token loop (s = 5) and a decode step
    (s = 1). Outputs within 1e-5 relative, new states within 1e-5."""
    jc, tc = reduced["jc"], reduced["tc"]
    jblk = jax.tree.map(lambda x: x[1], reduced["jp"]["scan"][0])
    tblk = {k: {kk: vv[1] for kk, vv in v.items()}
            for k, v in reduced["tp"]["scan"][0].items()}
    x = np.random.default_rng(s).standard_normal(
        (2, s, jc.d_model)).astype(np.float32)
    st = _block_state(jc, 2, seed=s)
    tst = {k: t(v) for k, v in st.items()}
    with jax.disable_jit():
        jy, jst = jRW.rwkv_time_mix(jblk["time_mix"], jc, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in st.items()})
        jy2, jst2 = jRW.rwkv_channel_mix(jblk["channel_mix"], jc, jy, jst)
    ty, tst = RW.rwkv_time_mix(tblk["time_mix"], tc, t(x), tst)
    ty2, tst2 = RW.rwkv_channel_mix(tblk["channel_mix"], tc, ty, tst)
    assert _rel(ty, jy) < 1e-5
    assert _rel(ty2, jy2) < 1e-5
    for key in ("tm_shift", "cm_shift", "wkv"):
        assert _abs(tst2[key], jst2[key]) < 1e-5, key


def test_norms_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(
        np.float32)
    p = {"scale": np.linspace(0.5, 1.5, 64).astype(np.float32),
         "bias": np.linspace(-1, 1, 64).astype(np.float32)}
    for kind in ("layernorm", "rmsnorm"):
        want = jnorms.apply_norm(kind, {k: jnp.asarray(v) for k, v in
                                        p.items()}, jnp.asarray(x), 1e-6)
        got = norms.apply_norm(kind, {k: t(v) for k, v in p.items()}, t(x),
                               1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# -- the whole model --------------------------------------------------------------

def test_forward_matches_eager_jax(reduced):
    """Logits of a 32-token forward (two 16-token chunks per layer), eager
    JAX against the port: within 1e-5 relative to the largest logit."""
    jc, tc = reduced["jc"], reduced["tc"]
    toks = np.random.default_rng(1).integers(0, jc.vocab, (1, 32)).astype(
        np.int32)
    with jax.disable_jit():
        want, _ = jM.forward(reduced["jp"], jc, jnp.asarray(toks))
    got, aux = M.forward(reduced["tp"], tc, t(toks))
    assert _rel(got, want) < 1e-5
    assert float(aux) == 0.0


def test_prefill_and_decode_steps_match_eager_jax(reduced):
    """prefill of 48 tokens into a batch-2 state (chunked WKV), then two
    decode steps: logits and every state leaf within 1e-5 relative to their
    largest value (the WKV state grows to ~5 over four layers), lengths
    equal. The port updates the state in place."""
    jc, tc = reduced["jc"], reduced["tc"]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jc.vocab, (2, 48)).astype(np.int32)
    steps = rng.integers(0, jc.vocab, (2, 2, 1)).astype(np.int32)
    jst = jM.init_state(jc, 2, 64)
    tst = M.init_state(tc, 2, 64, device="cpu")
    with jax.disable_jit():
        jl, jst = jM.prefill(reduced["jp"], jc, jnp.asarray(toks), jst)
        jls = []
        for s in steps:
            lo, jst = jM.decode_step(reduced["jp"], jc, jnp.asarray(s), jst)
            jls.append(lo)
    tl, tst2 = M.prefill(reduced["tp"], tc, t(toks), tst)
    assert tst2 is tst
    assert _rel(tl, jl) < 1e-5
    for s, jlo in zip(steps, jls):
        tlo, tst = M.decode_step(reduced["tp"], tc, t(s), tst)
        assert _rel(tlo, jlo) < 1e-5
    for key in ("tm_shift", "cm_shift", "wkv"):
        assert _rel(tst["scan"][0][key], jst["scan"][0][key]) < 1e-5, key
    assert_bits_equal(tst["length"], jst["length"])


def test_prefill_into_slot_matches_jax(reduced):
    """Two chunks (32 + 4) into slot 1 of a 3-slot grid: the same logits
    and the same grid as the JAX function (other slots untouched), within
    1e-5 relative."""
    jc, tc = reduced["jc"], reduced["tc"]
    toks = np.random.default_rng(3).integers(0, jc.vocab, (1, 36)).astype(
        np.int32)
    jst = jM.init_state(jc, 3, 64)
    tst = M.init_state(tc, 3, 64, device="cpu")
    with jax.disable_jit():
        _, jst = jM.prefill_into_slot(reduced["jp"], jc, jnp.asarray(
            toks[:, :32]), jst, 1, 0)
        jl, jst = jM.prefill_into_slot(reduced["jp"], jc, jnp.asarray(
            toks[:, 32:]), jst, 1, 32)
    _, tst = M.prefill_into_slot(reduced["tp"], tc, t(toks[:, :32]), tst, 1,
                                 0)
    tl, tst = M.prefill_into_slot(reduced["tp"], tc, t(toks[:, 32:]), tst, 1,
                                  32)
    assert _rel(tl, jl) < 1e-5
    for key in ("tm_shift", "cm_shift", "wkv"):
        got, want = n(tst["scan"][0][key]), n(jst["scan"][0][key])
        assert _rel(got, want) < 1e-5, key
        assert not got[:, [0, 2]].any()
    assert_bits_equal(tst["length"], jst["length"])


def test_prepack_params_planes_equal_bit_for_bit(reduced):
    """``prepack_params`` at <8:8>: every projection's codes, planes, column
    sums and scale equal the JAX package's, rep by rep (the stacked leaves
    pack per rep as JAX's vmap does), the head too."""
    jc, tc = reduced["jc"], reduced["tc"]
    jpk = jM.prepack_params(reduced["jp"], JPIMQuantConfig(8, 8, "int-direct"))
    tpk = M.prepack_params(reduced["tp"], PIMQuantConfig(8, 8, "int-direct"))
    checked = 0
    for half in ("time_mix", "channel_mix"):
        for key, jw in jpk["scan"][0][half].items():
            tw = tpk["scan"][0][half][key]
            if not hasattr(jw, "planes"):
                assert isinstance(tw, torch.Tensor), key
                continue
            assert len(tw) == jc.n_layers
            for r in range(jc.n_layers):
                assert_bits_equal(tw[r].planes, jw.planes[r])
                assert_bits_equal(tw[r].codes32, jw.codes[r])
                assert_bits_equal(tw[r].col_sums, jw.col_sums[r])
                assert_bits_equal(tw[r].wq.scale, jw.wq.scale[r])
                checked += 1
    assert checked == 8 * jc.n_layers     # w_r, w_k, w_v, w_g, w_o + 3 FFN
    assert_bits_equal(tpk["head"].planes, jpk["head"].planes)
    assert isinstance(tpk["embed"], torch.Tensor)
    assert M.prepack_params(reduced["tp"], None) is reduced["tp"]


def test_cast_params_casts_the_leaves_jax_casts(reduced):
    jcast = jM.cast_params(reduced["jp"], jnp.bfloat16)
    tcast = M.cast_params(reduced["tp"], torch.bfloat16)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jcast):
        got = tcast
        for key in path:
            got = got[key.key if hasattr(key, "key") else key.idx]
        want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 else torch.float32
        assert got.dtype == want, path


def test_bf16_model_close_to_jax(reduced):
    """The published dtype: both packages cast the same weights to bf16
    (``cast_params``) and run a 32-token forward, JAX jitted. bf16 rounds at
    other places in the two frameworks, so the bound is loose: logits within
    10% of the largest (the JAX package's own jitted and eager bf16 runs
    differ by 4.5% on these weights with u = 0, the port from either by 4-6%),
    and the greedy token at the last position equal."""
    jc, tc = (dataclasses.replace(c, dtype="bfloat16")
              for c in (reduced["jc"], reduced["tc"]))
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 32)).astype(
        np.int32)
    want, _ = jax.jit(jM.forward, static_argnums=1)(
        jM.cast_params(reduced["jp"], jnp.bfloat16), jc, jnp.asarray(toks))
    got, _ = M.forward(M.cast_params(reduced["tp"], torch.bfloat16), tc,
                       t(toks))
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-1
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  np.asarray(want)[:, -1].argmax(-1))


def test_other_block_kinds_raise_until_ported():
    """Every block kind of the JAX package is ported (``cross_attn`` was
    the last); a kind it does not have raises ``ValueError``, as there."""
    _, tc = _cfgs(block_pattern=("cross_attn",), n_image_tokens=4)
    p = M.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert "gate" in p["scan"][0]["attn"]
    assert M.init_state(tc, 1, 8, device="cpu")["scan"][0]["k"].shape[2] == 4
    _, bad = _cfgs(block_pattern=("mamba",))
    with pytest.raises(ValueError, match="mamba"):
        M.init(bad, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        M.init_state(bad, 1, 8, device="cpu")


# -- configs and conversion --------------------------------------------------------

def test_rwkv6_3b_config_matches_jax():
    jarch, tarch = jget_config("rwkv6-3b"), get_config("rwkv6-3b")
    jd = dataclasses.asdict(jarch.model)
    td = dataclasses.asdict(tarch.model)
    assert jd == td
    assert tarch.model.n_params() == jarch.model.n_params()
    assert dataclasses.asdict(tarch.model.reduced()) == dataclasses.asdict(
        jarch.model.reduced())
    assert (tarch.arch_id, tarch.source, tarch.notes) == (
        jarch.arch_id, jarch.source, jarch.notes)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert M.layer_plan(tarch.model) == jM.layer_plan(jarch.model)


def test_registry_lists_only_ported_archs():
    """All ten archs of the JAX registry are ported, each with the JAX
    package's config."""
    from repro.configs import ARCH_IDS as JARCH_IDS

    assert ARCH_IDS == ("llama3.2-3b", "qwen1.5-4b", "qwen3-0.6b",
                        "granite-3-2b", "rwkv6-3b", "recurrentgemma-9b",
                        "phi3.5-moe-42b-a6.6b", "grok-1-314b",
                        "musicgen-large", "llama-3.2-vision-90b")
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS) and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch).model) == \
            dataclasses.asdict(jget_config(arch).model)
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-5")


def test_params_from_jax_carries_lists_and_bf16_leaves(reduced):
    tree = jax.device_get(jM.cast_params(reduced["jp"], jnp.bfloat16))
    got = convert.params_from_jax(tree)
    assert isinstance(got["scan"], list) and isinstance(got["rest"], list)
    w = got["scan"][0]["time_mix"]["w_r"]
    assert w.dtype == torch.bfloat16
    assert w.shape == tree["scan"][0]["time_mix"]["w_r"].shape
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(tree["scan"][0]["time_mix"]["w_r"], np.float32))
    assert got["final_norm"]["scale"].dtype == torch.float32
