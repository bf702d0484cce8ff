"""The port's MoE FFN (``models/lm/moe.py``), its expert-bank prepack
(``core/packed.py``) and the Eq. 1 product over a bank
(``core/bitserial.py::int_matmul_prepacked_bank``, kernel 2's batched
entry) against the JAX package on the CPU.

At reduced phi3.5-moe's FFN width (d_model 128, 4 experts top-2, d_ff 256)
and reduced grok-1's (gelu-gated): the bank prepack bit for bit with the
JAX package's ``vmap``-ed prepack and with E single prepacks; the routing
(router logits, top-k, the stable sort, slots, drops, the trash slot) bit
for bit given the same x, read from the JAX function as it runs; the aux
loss and the drop fraction with and without drops; the float FFN within
1e-5; on the packed FFN the bank products equal on all four backends and
to the JAX package's int-direct products on the same codes, and the output
within the reference's own envelope; the batched plain version against a
loop of single calls (and its wrap mod 2^32); no NaN from an empty expert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitserial as jbs
from repro.core import packed as jpk
from repro.core.pim_layers import PIMQuantConfig as JPIMQuantConfig
from repro.models.lm import model as jM
from repro.models.lm import moe as jmoe
from repro_torch import convert
from repro_torch.core import PIMQuantConfig, bitserial, packed
from repro_torch.kernels import bitserial_matmul as km
from repro_torch.kernels import ops
from repro_torch.models.lm import model as M
from repro_torch.models.lm import moe as tmoe

from _torch_parity import (MOE_ARCHS, assert_bits_equal, assert_close,
                           moe_cfgs, n, normal, rel_err, t)

# The reference's envelope of max |packed - float| / max |float| by
# precision (tests/test_moe_packed.py); <2:2> is only held finite.
_TOL = {8: 0.15, 4: 1.0, 2: None}


@pytest.fixture(scope="module", params=MOE_ARCHS)
def ffn(request):
    """One MoE FFN of the reduced ``arch`` in both packages, float32, and
    an input of 32 tokens."""
    jc, tc = moe_cfgs(request.param)
    jp = jax.device_get(jmoe.init_moe(jc, jax.random.PRNGKey(0)))
    x = normal(np.random.default_rng(1), (4, 8, jc.d_model), 0.5)
    return dict(jc=jc, tc=tc, jp=jp, tp=convert.params_from_jax(jp), x=x)


class _Recorder:
    """Stands in for a module global of ``repro.models.lm.moe`` (``jnp``,
    or ``jax`` with its ``lax``) and keeps the results of the named calls
    in order, so the reference's routing can be read as it runs."""

    def __init__(self, target, names, calls):
        self._target, self._names, self._calls = target, names, calls

    def __getattr__(self, name):
        fn = getattr(self._target, name)
        if name == "lax":
            return _Recorder(fn, self._names, self._calls)
        if name not in self._names:
            return fn

        def rec(*a, **k):
            out = fn(*a, **k)
            self._calls.setdefault(name, []).append((a, out))
            return out
        return rec


def _jax_moe(monkeypatch, p, cfg, x):
    """The JAX package's ``moe_ffn`` run eagerly, with its router logits
    (the first einsum), top-k, sort order and slots (the first where,
    whose condition is ``keep``)."""
    calls = {}
    monkeypatch.setattr(jmoe, "jnp", _Recorder(
        jnp, ("einsum", "argsort", "where"), calls))
    monkeypatch.setattr(jmoe, "jax", _Recorder(jax, ("top_k",), calls))
    with jax.disable_jit():
        y, aux = jmoe.moe_ffn(p, cfg, jnp.asarray(x))
    monkeypatch.undo()
    (keep, _, _), slot = calls["where"][0]
    gates, ids = calls["top_k"][0][1]
    return dict(y=np.asarray(y), aux={k: np.asarray(v) for k, v in
                                      aux.items()},
                logits=np.asarray(calls["einsum"][0][1])[0],
                ids=np.asarray(ids)[0], order=np.asarray(
                    calls["argsort"][0][1])[0],
                keep=np.asarray(keep)[0], slot=np.asarray(slot)[0])


# -- the bank prepack ------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bank_prepack_equals_single_prepacks_and_jax(bits):
    """An (E, K, N) bank with K off a word: codes, planes, column sums and
    each expert's scale and qmin equal E single prepacks and the JAX
    package's ``vmap``-ed prepack bit for bit; ``to_float`` is the stack of
    the singles'."""
    w = normal(np.random.default_rng(bits), (4, 70, 40))
    w[2] *= 3.0                                  # experts of other ranges
    bank = packed.prepack(t(w), bits)
    want = jax.vmap(lambda a: jpk.prepack(a, bits))(jnp.asarray(w))
    assert bank.is_bank and bank.shape == (4, 70, 40)
    assert bank.codes.dtype == torch.uint8 and bank.bits == bits
    assert_bits_equal(bank.codes32, want.codes)
    assert_bits_equal(bank.planes, want.planes)
    assert_bits_equal(bank.col_sums, want.col_sums)
    assert_bits_equal(bank.wq.scale, want.wq.scale)
    assert_bits_equal(bank.wq.qmin, want.wq.qmin)
    singles = [packed.prepack(t(a), bits) for a in w]
    for name in ("codes", "planes", "col_sums"):
        assert torch.equal(getattr(bank, name), torch.stack(
            [getattr(s, name) for s in singles]))
    assert torch.equal(bank.to_float(), torch.stack(
        [s.to_float() for s in singles]))


def test_prepack_params_packs_banks_and_leaves_the_router():
    """A scan-stacked (R, E, d, f) expert leaf becomes a list of R banks
    (one pack each); the router stays float32; attention projections pack
    as before."""
    _, tc = moe_cfgs()
    params = M.init(tc, torch.Generator().manual_seed(0), device="cpu")
    pp = M.prepack_params(params, PIMQuantConfig(8, 8))
    ffn = pp["scan"][0]["ffn"]
    assert ffn["router"] is params["scan"][0]["ffn"]["router"]
    for k in ("w_in", "w_gate", "w_out"):
        assert isinstance(ffn[k], list) and len(ffn[k]) == tc.n_layers
        assert all(isinstance(b, packed.PackedWeight) and b.is_bank
                   for b in ffn[k])
    assert ffn["w_out"][0].shape == (4, tc.d_ff, tc.d_model)
    assert isinstance(pp["scan"][0]["attn"]["wq"][0], packed.PackedWeight)


# -- routing and the float FFN ----------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_routing_matches_jax(ffn, monkeypatch, capacity_factor):
    """Given the same x: router logits within 1e-6, the same top-k, and
    order, keep, slot and source tokens bit for bit, with capacity that
    drops (0.5) and the configs' (1.25); the aux loss within 1e-6 and the
    drop fraction equal."""
    jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=capacity_factor)) for c in (ffn["jc"],
                                                           ffn["tc"]))
    want = _jax_moe(monkeypatch, ffn["jp"], jc, ffn["x"])
    x2 = t(ffn["x"]).reshape(-1, jc.d_model)
    r = tmoe.route(ffn["tp"], tc, x2)
    logits = x2 @ ffn["tp"]["router"]
    assert_close(logits, want["logits"], rtol=1e-6)
    k = tc.moe.top_k
    np.testing.assert_array_equal(r.order.numpy(), want["order"])
    np.testing.assert_array_equal(r.src_token.numpy(), want["order"] // k)
    np.testing.assert_array_equal(r.keep.numpy(), want["keep"])
    np.testing.assert_array_equal(r.slot.numpy(), want["slot"])
    ids = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                     stable=True)[1][:, :k]
    np.testing.assert_array_equal(ids.numpy(), want["ids"])
    assert r.cap == jmoe._capacity(32, jc)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (capacity_factor == 0.5)
    assert abs(float(r.aux["loss"]) - float(want["aux"]["loss"])) <= \
        1e-6 * abs(float(want["aux"]["loss"]))
    assert float(r.aux["drop"]) == float(want["aux"]["drop"]) == \
        dropped / (32 * k)
    assert float(r.aux["layers"]) == 1.0


def test_top_k_takes_the_lower_expert_on_ties(ffn, monkeypatch):
    """Two identical router columns give exactly tied probabilities; the
    port, like ``jax.lax.top_k``, takes the lower expert first."""
    jp = dict(ffn["jp"], router=np.array(ffn["jp"]["router"]))
    jp["router"][:, 3] = jp["router"][:, 1]
    want = _jax_moe(monkeypatch, jp, ffn["jc"], ffn["x"])
    r = tmoe.route(convert.params_from_jax(jp), ffn["tc"],
                   t(ffn["x"]).reshape(-1, ffn["jc"].d_model))
    flat = want["ids"].reshape(-1)
    assert ((flat == 1) | (flat == 3)).any()
    np.testing.assert_array_equal(r.order.numpy(), want["order"])
    np.testing.assert_array_equal(r.slot.numpy(), want["slot"])


def test_float_ffn_matches_jax(ffn, monkeypatch):
    """The float expert FFN and combine, float32, within 1e-5 of the
    largest output; the aux dict's values."""
    want = _jax_moe(monkeypatch, ffn["jp"], ffn["jc"], ffn["x"])
    y, aux = tmoe.moe_ffn(ffn["tp"], ffn["tc"], t(ffn["x"]))
    assert y.dtype == torch.float32 and y.shape == ffn["x"].shape
    assert_close(y, want["y"], rtol=1e-5)
    assert float(aux["drop"]) == float(want["aux"]["drop"])


# -- the packed FFN -----------------------------------------------------------------

def _packed(ffn, bits, backend="int-direct"):
    jc = dataclasses.replace(ffn["jc"], pim=JPIMQuantConfig(
        bits, bits, backend="int-direct"))
    tc = dataclasses.replace(ffn["tc"], pim=PIMQuantConfig(
        bits, bits, backend=backend))
    return (jc, jM.prepack_params(ffn["jp"], jc.pim), tc,
            M.prepack_params(ffn["tp"], tc.pim))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bank_products_equal_on_every_backend_and_jax(ffn, bits):
    """The first stage's codes dispatched by the port, contracted against
    the w_in bank: P equal on all four backends, and to the JAX package's
    int-direct products under ``vmap`` on the same codes."""
    jc, jpp, tc, tpp = _packed(ffn, bits)
    x2 = t(ffn["x"]).reshape(-1, tc.d_model)
    disp = tmoe.dispatch(tpp, tc, x2, tmoe.route(tpp, tc, x2))
    qa, bank = disp["qa"], tpp["w_in"]
    assert qa.dtype == torch.int32 and qa.shape[0] == tc.moe.n_experts
    want = jax.vmap(lambda q, w: jbs.int_matmul_prepacked(
        q, w, bits, backend="int-direct"))(jnp.asarray(qa.numpy()),
                                           jpp["w_in"])
    for backend in bitserial.BACKENDS:
        got = bitserial.int_matmul_prepacked_bank(qa, bank, bits, backend)
        assert_bits_equal(got, want)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_packed_ffn_within_the_reference_envelope(ffn, monkeypatch, bits):
    """The packed FFN on "cuda" (the plain versions here): routing and aux
    equal to the float path's, finite, and within the reference's
    envelope of the float output; at <8:8> within 1e-3 of the largest
    output of the JAX package's packed FFN (codes of h can flip by a float
    ulp)."""
    jc, jpp, tc, tpp = _packed(ffn, bits, backend="cuda")
    y, aux = tmoe.moe_ffn(tpp, tc, t(ffn["x"]))
    yf, auxf = tmoe.moe_ffn(ffn["tp"], ffn["tc"], t(ffn["x"]))
    for k in aux:
        assert torch.equal(aux[k], auxf[k]), k
    assert torch.isfinite(y).all()
    if _TOL[bits] is not None:
        assert rel_err(y, yf.numpy()) < _TOL[bits]
    if bits == 8:
        with jax.disable_jit():
            want, _ = jmoe.moe_ffn(jpp, jc, jnp.asarray(ffn["x"]))
        assert rel_err(y, np.asarray(want)) < 1e-3


def test_empty_experts_give_no_nan(ffn):
    """A router that sends every token to experts 0 and 1 leaves 2 and 3
    empty: their hidden calibration takes the guarded scale, and the
    output stays finite and close to the float path's."""
    tp = dict(ffn["tp"])
    tp["router"] = torch.zeros_like(tp["router"])
    tp["router"][:, 2:] = -1.0          # logits of about -d_model
    x = torch.ones(4, 8, ffn["tc"].d_model) + t(ffn["x"]) * 0.1
    r = tmoe.route(tp, ffn["tc"], x.reshape(-1, ffn["tc"].d_model))
    assert set(r.slot[r.keep].div(r.cap, rounding_mode="floor").tolist()) \
        == {0, 1}
    jc, _, tc, tpp = _packed(dict(ffn, tp=tp), 8, backend="cuda")
    y, _ = tmoe.moe_ffn(tpp, tc, x)
    yf, _ = tmoe.moe_ffn(tp, ffn["tc"], x)
    assert torch.isfinite(y).all()
    assert rel_err(y, yf.numpy()) < _TOL[8]


# -- kernel 2's batched entry: the plain version --------------------------------------

@pytest.mark.parametrize("e,m,k,nn,bits", [(3, 5, 70, 40, 8), (2, 17, 33, 9, 4),
                                           (4, 8, 128, 64, 2)])
def test_batched_plain_equals_single_calls(e, m, k, nn, bits):
    """The batched wrapper on CPU tensors is the plain version, equal to a
    loop of single calls; it counts no launch."""
    rng = np.random.default_rng(e)
    qa = t(rng.integers(0, 2**bits, (e, m, k)).astype(np.int32))
    bank = packed.prepack(t(normal(rng, (e, k, nn))), bits)
    ops.reset_launch_counts()
    got = ops.bitserial_matmul_batched(qa, a_bits=bits, w_bits=bits,
                                       pw=bank.planes)
    assert not any(ops.launch_counts().values())
    assert "bitserial_matmul_fused_batched" in ops.launch_counts()
    want = torch.stack([km.bitserial_matmul_fused(qa[i], bank.planes[i],
                                                  bits, bits)
                        for i in range(e)])
    assert torch.equal(got, want)
    assert torch.equal(got, bitserial.int_matmul_direct(qa, bank.codes))


def test_batched_plain_wraps_like_the_reference():
    """Every code 255 at <8:8>, K = 33,056: P = 65,025 * K passes 2^31 and
    wraps mod 2^32 in every expert, as the JAX package's int32 product."""
    e, m, k, nn = 2, 2, 33056, 3
    qa = np.full((e, m, k), 255, np.int32)
    pw = ops.pack_planes(t(np.full((e * nn, k), 255, np.int32)), 8).reshape(
        8, e, nn, -1).transpose(0, 1).contiguous()
    want = jbs.int_matmul_direct(jnp.asarray(qa[0]),
                                 jnp.full((k, nn), 255, jnp.int32))
    got = km.bitserial_matmul_fused_batched(t(qa), pw, 8, 8)
    assert int(want[0, 0]) < 0
    for i in range(e):
        assert_bits_equal(got[i], want)


def test_batched_wrapper_refuses_what_the_kernel_does_not_take():
    qa = torch.zeros((2, 4, 64), dtype=torch.int32)
    pw = torch.zeros((2, 8, 5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 codes"):
        km.bitserial_matmul_fused_batched(qa[0], pw, 8, 8)
    with pytest.raises(ValueError, match="planes"):
        km.bitserial_matmul_fused_batched(qa, pw[:1], 8, 8)
    with pytest.raises(ValueError, match="exceeds"):
        km.bitserial_matmul_fused_batched(
            torch.zeros((2, 4, 65), dtype=torch.int32), pw, 8, 8)
    with pytest.raises(ValueError, match="1..8 bits"):
        km.bitserial_matmul_fused_batched(qa, pw, 9, 8)
    assert n(km.bitserial_matmul_fused_batched(qa, pw, 8, 8)).shape == \
        (2, 4, 5)
