"""The port's RG-LRU block (recurrentgemma-9b's recurrent layers) against
the JAX package on the CPU: the config and its layer plan, the parameter
tree and its prepack, the causal conv, the gates, the scan and the decode
step, and the whole block in float32 and bf16, prefill and step.

Inputs are made with numpy from a seed and given to both packages, at
``recurrentgemma-9b``'s ``reduced()`` width (d_model 128, lru_width 128).
The JAX side runs op by op (``jax.disable_jit``, "eager"). Tolerances:
float32 within 1e-5 of the largest value, except where a test says bit
for bit (the conv, the scan of given maps, the folded carry); bf16 within
the reference's own bf16 spread (its jitted run against its eager run).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.models.lm import model as jM
from repro.models.lm import rglru as jRG
from repro_torch.configs import get_config
from repro_torch.core import PIMQuantConfig
from repro_torch.core.packed import PackedWeight
from repro_torch.models.lm import model as M
from repro_torch.models.lm import rglru as RG

from _torch_parity import (HYBRID, assert_bits_equal, assert_close,
                           check_tree_carried, hybrid_cfgs, hybrid_params,
                           n, normal, rel_err, t)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hybrid():
    """reduced recurrentgemma-9b in float32: configs and one set of weights
    in both packages, and the first rglru block's parameters."""
    jc, tc = hybrid_cfgs()
    jp, tp = hybrid_params(jc)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp,
                jblk=jax.tree.map(lambda x: x[0], jp["scan"][0]["rglru"]),
                tblk={k: v[0] for k, v in tp["scan"][0]["rglru"].items()})


def _eager(fn, *args):
    with jax.disable_jit():
        return jax.tree.map(np.asarray, fn(*args))


# -- config and parameters -------------------------------------------------------

def test_config_and_layer_plan_match_jax():
    jarch, tarch = jget_config(HYBRID), get_config(HYBRID)
    assert dataclasses.asdict(tarch.model) == dataclasses.asdict(jarch.model)
    assert dataclasses.asdict(tarch.model.reduced()) == dataclasses.asdict(
        jarch.model.reduced())
    assert (tarch.arch_id, tarch.source, tarch.notes) == (
        jarch.arch_id, jarch.source, jarch.notes)
    assert tarch.model.n_params() == jarch.model.n_params()
    unit = ("rglru", "rglru", "local_attn")
    assert M.layer_plan(tarch.model) == jM.layer_plan(jarch.model) == (
        unit, 12, ("rglru", "rglru"))
    for n_layers in (4, 11):   # one unit of four; three units and two more
        cfgs = [c.model.reduced(n_layers=n_layers) for c in (jarch, tarch)]
        assert M.layer_plan(cfgs[1]) == jM.layer_plan(cfgs[0])


def test_params_from_jax_carries_the_hybrid_tree(hybrid):
    own = M.init(hybrid["tc"], torch.Generator().manual_seed(0),
                 device="cpu")
    check_tree_carried(hybrid["jp"], hybrid["tp"], own)
    assert set(hybrid["tp"]["scan"][0]["rglru"]) == {
        "w_x", "w_gate", "conv", "w_a", "b_a", "w_i", "b_i", "lam", "w_out"}


def test_bf16_tree_keeps_each_leafs_dtype():
    """``cast_params`` makes the stacked lam, b_a, b_i and conv bf16 and
    leaves a remainder layer's vectors float32, in both packages."""
    jc, tc = hybrid_cfgs(n_layers=11, dtype="bfloat16")
    jp, tp = hybrid_params(jc, dtype=jnp.bfloat16)
    ours = M.cast_params(M.init(tc, torch.Generator().manual_seed(0),
                                device="cpu"), torch.bfloat16)
    for tree in (tp, ours):
        scan, rest = tree["scan"][0]["rglru"], tree["rest"][0]["rglru"]
        assert {k: v.dtype for k, v in scan.items()} == dict.fromkeys(
            scan, torch.bfloat16)
        assert {k for k, v in rest.items() if v.dtype == torch.float32} == {
            "lam", "b_a", "b_i"}
    np.testing.assert_array_equal(
        tp["rest"][1]["rglru"]["lam"].numpy(),
        np.asarray(jp["rest"][1]["rglru"]["lam"]))


def test_prepack_params_packs_the_references_keys(hybrid):
    """w_x, w_gate, w_out, the attention and MLP projections and the head
    pack; the gate weights w_a, w_i stay float."""
    cfg = JPIMQuantConfig(8, 8, backend="int-direct")
    jpk = jax.device_get(jax.jit(lambda p: jM.prepack_params(p, cfg))(
        hybrid["jp"]))
    tpk = M.prepack_params(hybrid["tp"], PIMQuantConfig(8, 8))

    def packed_paths(tree, is_packed, path=()):
        if is_packed(tree):
            return {path}
        if isinstance(tree, dict):
            return set().union(*(packed_paths(v, is_packed, path + (k,))
                                 for k, v in tree.items()))
        if isinstance(tree, list) and tree and all(
                isinstance(x, PackedWeight) for x in tree):
            return {path}
        if isinstance(tree, list):
            return set().union(set(), *(packed_paths(v, is_packed,
                                                     path + (i,))
                                        for i, v in enumerate(tree)))
        return set()

    from repro.core.packed import PackedWeight as JPackedWeight

    want = packed_paths(jpk, lambda x: isinstance(x, JPackedWeight))
    got = packed_paths(tpk, lambda x: isinstance(x, PackedWeight))
    assert got == want
    rg = tpk["scan"][0]["rglru"]
    assert {k for k, v in rg.items() if isinstance(v, list)} == {
        "w_x", "w_gate", "w_out"}
    assert isinstance(rg["w_a"], torch.Tensor) and isinstance(
        rg["w_i"], torch.Tensor)
    assert_bits_equal(rg["w_x"][0].codes32,
                      np.asarray(jpk["scan"][0]["rglru"]["w_x"].codes)[0])
    assert_bits_equal(rg["w_x"][0].planes,
                      np.asarray(jpk["scan"][0]["rglru"]["w_x"].planes)[0])


# -- the parts of the block --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bit_for_bit(hybrid, dtype, with_state):
    """The taps cast to x's dtype and summed in Python's order: equal bit
    for bit, the new state too (a bf16 x pads with its float32 state cast
    to bf16)."""
    rng = np.random.default_rng(1)
    w = hybrid["tc"].lru_width
    x = normal(rng, (2, 7, w))
    conv = normal(rng, (4, w), 0.3)
    state = normal(rng, (2, 3, w)) if with_state else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _eager(jRG._causal_conv, jnp.asarray(conv).astype(jdt),
                  jnp.asarray(x).astype(jdt),
                  None if state is None else jnp.asarray(state))
    got = RG._causal_conv(t(conv).to(tdt), t(x).to(tdt),
                          None if state is None else t(state))
    for g, w_ in zip(got, want):
        assert g.dtype == tdt
        assert_bits_equal(g.float(), np.asarray(w_, np.float32))


@pytest.mark.parametrize("rank", [2, 3])
def test_gates_match_jax(hybrid, rank):
    """(B, S, W) for the scan and (B, W) for the step."""
    rng = np.random.default_rng(2)
    x = normal(rng, (3, 9, hybrid["tc"].lru_width)[3 - rank:])
    ja, jb = _eager(jRG._gates, hybrid["jblk"], jnp.asarray(x))
    ta, tb = RG._gates(hybrid["tblk"], t(x))
    assert_close(ta, ja, rtol=1e-5)
    assert_close(tb, jb, rtol=1e-5)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 7, 16, 64])
def test_affine_scan_bit_for_bit_with_associative_scan(s):
    """Given the same maps, the scan's products are the reference's, in
    its order: equal bit for bit at every length, odd ones included."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.3, 1.0, (2, s, 16)).astype(np.float32)
    b = normal(rng, (2, s, 16))

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    wa, wb = _eager(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1), jnp.asarray(a), jnp.asarray(b))
    ga, gb = RG.affine_scan(t(a), t(b))
    assert_bits_equal(ga, wa)
    assert_bits_equal(gb, wb)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 7, 16, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(hybrid, s, with_h0):
    rng = np.random.default_rng(10 + s)
    w = hybrid["tc"].lru_width
    x = normal(rng, (2, s, w))
    h0 = normal(rng, (2, w)) if with_h0 else None
    jy, jh = _eager(jRG.rglru_scan, hybrid["jblk"], jnp.asarray(x),
                    None if h0 is None else jnp.asarray(h0))
    ty, th = RG.rglru_scan(hybrid["tblk"], t(x),
                           None if h0 is None else t(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    assert_close(ty, jy, rtol=1e-5)
    assert_close(th, jh, rtol=1e-5)


def test_rglru_scan_folds_the_carry_as_the_reference(hybrid):
    """On the same gates, the carry folded into b[:, 0] and the scan give
    the reference's h bit for bit."""
    rng = np.random.default_rng(3)
    w = hybrid["tc"].lru_width
    x, h0 = normal(rng, (2, 5, w)), normal(rng, (2, w))
    a, b = RG._gates(hybrid["tblk"], t(x))
    b[:, 0] += a[:, 0] * t(h0)
    want = _eager(lambda a, b: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (a, b), axis=1)[1],
        jnp.asarray(n(a)), jnp.asarray(n(b)))
    _, got = RG.affine_scan(a, b)
    assert_bits_equal(got, want)


def test_rglru_step_matches_jax_and_the_scan(hybrid):
    rng = np.random.default_rng(4)
    w = hybrid["tc"].lru_width
    x, h = normal(rng, (3, w)), normal(rng, (3, w))
    jy, jh = _eager(jRG.rglru_step, hybrid["jblk"], jnp.asarray(x),
                    jnp.asarray(h))
    ty, th = RG.rglru_step(hybrid["tblk"], t(x), t(h))
    assert_close(ty, jy, rtol=1e-5)
    assert_close(th, jh, rtol=1e-5)
    sy, sh = RG.rglru_scan(hybrid["tblk"], t(x)[:, None], t(h))
    assert_close(sh, th.numpy(), rtol=1e-6)


# -- the whole block -----------------------------------------------------------------

def _block_inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    w = cfg.lru_width
    return (normal(rng, (2, s, cfg.d_model)),
            {"conv": normal(rng, (2, 3, w)), "h": normal(rng, (2, w))})


@pytest.mark.parametrize("s", [1, 13])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_float32_matches_jax(hybrid, s, with_state):
    """Prefill (S = 13) and the step path (S = 1 with a state, as a
    one-token chunk or decode takes it); without a state S = 1 scans."""
    x, st = _block_inputs(hybrid["tc"], s, 20 + s)
    st = st if with_state else None
    jout, jst = _eager(jRG.rglru_block, hybrid["jblk"], hybrid["jc"],
                       jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    tout, tst = RG.rglru_block(hybrid["tblk"], hybrid["tc"], t(x),
                               None if st is None else
                               {k: t(v) for k, v in st.items()})
    assert_close(tout, jout, rtol=1e-5)
    assert (tst is None) == (jst is None)
    if tst is not None:
        assert_close(tst["h"], jst["h"], rtol=1e-5)
        assert_close(tst["conv"], jst["conv"], rtol=1e-5)


@pytest.mark.parametrize("s", [1, 13])
@pytest.mark.parametrize("leaf_dtype", ["bfloat16", "float32"])
def test_rglru_block_bf16_within_the_references_spread(s, leaf_dtype):
    """bf16 activations and projections; lam, b_a, b_i bf16 (a scanned
    layer's) or float32 (a remainder layer's). The port's distance from
    the eager reference stays within the reference's own jit-vs-eager
    spread (at least a bf16 ulp) twice over."""
    jc, tc = hybrid_cfgs(dtype="bfloat16")
    jp, tp = hybrid_params(jc, dtype=jnp.bfloat16)
    jblk = jax.tree.map(lambda x: x[0], jp["scan"][0]["rglru"])
    tblk = {k: v[0] for k, v in tp["scan"][0]["rglru"].items()}
    if leaf_dtype == "float32":
        for k in ("lam", "b_a", "b_i"):
            jblk[k] = np.asarray(jblk[k], np.float32)
            tblk[k] = tblk[k].float()
    x, st = _block_inputs(tc, s, 30 + s)
    jx = jnp.asarray(x, jnp.bfloat16)
    jst = jax.tree.map(jnp.asarray, st)
    want, wst = _eager(jRG.rglru_block, jblk, jc, jx, jst)
    jit, _ = jax.tree.map(np.asarray, jax.jit(
        lambda p, x, s: jRG.rglru_block(p, jc, x, s))(jblk, jx, jst))
    got, gst = RG.rglru_block(tblk, tc, t(x).to(torch.bfloat16),
                              {k: t(v) for k, v in st.items()})
    assert got.dtype == torch.bfloat16 and gst["h"].dtype == torch.float32
    spread = max(rel_err(jit.astype(np.float32), want), 2.0**-8)
    assert rel_err(got.float(), want) <= 2 * spread
    assert rel_err(gst["h"], wst["h"]) <= 2 * spread
