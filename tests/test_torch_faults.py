"""The port's NAND-SPIN fault model (``repro_torch.pim.faults``) against
the JAX package's (``repro.pim.faults``), bit for bit.

torch and JAX draw different numbers for the same seed, so every test
here installs ``JaxDrawer`` (tests/_torch_parity.py): each of the port's
Bernoulli draws is ``jax.random.bernoulli`` on the reference's key for the
same path. The packed weights the port corrupts are built from the JAX
package's prepacked arrays (codes as bytes), so the tests hold the fault
model alone: corrupted codes, planes and fused planes, reports, checksum
flags, repairs, disturbed products on every backend, read sites, and the
cost model's redundancy factors.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxDrawer, assert_bits_equal, n, t
from repro.core import packed as jpacked
from repro.pim import cost_model as jcm
from repro.pim import faults as JF
from repro_torch.core import packed as tpacked
from repro_torch.core.quantize import QuantParams
from repro_torch.pim import cost_model as tcm
from repro_torch.pim import faults as TF


class CountingDrawer(TF.TorchDrawer):
    """The default drawer, counting its draws."""

    draws = 0

    def bernoulli(self, *a):
        self.draws += 1
        return super().bernoulli(*a)


def _cfgs(**kw):
    return JF.FaultConfig(**kw), TF.FaultConfig(**kw)


def port_pw(j) -> tpacked.PackedWeight:
    """The port's PackedWeight (or bank) from a JAX one's arrays."""
    bits = j.wq.bits
    return tpacked.PackedWeight(
        codes=tpacked.narrow_codes(t(j.codes), bits), planes=t(j.planes),
        col_sums=t(j.col_sums),
        wq=QuantParams(t(j.wq.scale), t(j.wq.qmin), bits))


def port_tree(j, stacked=False, bank=False):
    """A JAX packed tree in the port's layout: a scan-stacked leaf (under
    ``"scan"``) becomes a list of reps; a bank (under a router) stays one
    PackedWeight."""
    if isinstance(j, jpacked.PackedConvWeight):
        return tpacked.PackedConvWeight(
            mat=port_pw(j.mat), fused_planes=t(j.fused_planes),
            kernel_shape=tuple(j.kernel_shape))
    if isinstance(j, jpacked.PackedWeight):
        if stacked:
            return [port_pw(jax.tree.map(lambda x, r=r: x[r], j))
                    for r in range(j.codes.shape[0])]
        return port_pw(j)
    if isinstance(j, dict):
        return {k: port_tree(v, stacked or k == "scan", "router" in j)
                for k, v in j.items()}
    if isinstance(j, (list, tuple)):
        return type(j)(port_tree(v, stacked, bank) for v in j)
    return t(j)


def check_pw(got, want):
    """A port PackedWeight (or rep list) equals a JAX one bit for bit:
    codes (widened), planes, col_sums."""
    if isinstance(got, list):
        for r, g in enumerate(got):
            check_pw(g, jax.tree.map(lambda x, r=r: x[r], want))
        return
    if isinstance(got, tpacked.PackedConvWeight):
        check_pw(got.mat, want.mat)
        assert_bits_equal(got.fused_planes, want.fused_planes)
        return
    assert_bits_equal(got.codes32, want.codes)
    assert_bits_equal(got.planes, want.planes)
    assert_bits_equal(got.col_sums, want.col_sums)


# One weight shape throughout (K = 40: a whole word and a padded one), so
# the JAX package's eager ops compile once.
K, N = 40, 24


# The JAX package's prepack, jitted (an eager call compiles op by op): the
# port's weights are built from its arrays, so jit's ulps do not enter.
_prepack = jax.jit(jpacked.prepack, static_argnums=1)
_prepack_conv = jax.jit(jpacked.prepack_conv, static_argnums=1)


def _jpw(k=K, nn=N, bits=8, seed=0):
    rng = np.random.default_rng(seed)
    return _prepack(jnp.asarray(rng.standard_normal((k, nn)), jnp.float32),
                    bits)


# -- corruption core ----------------------------------------------------------

MECHS = {
    "write": dict(write_ber=2e-2),
    "retention": dict(retention_ber=2e-2),
    "stuck0": dict(stuck0_rate=2e-2),
    "stuck1": dict(stuck1_rate=2e-2),
    "subarray": dict(subarray_fail_rate=0.3, subarray_cols=8),
    "all_voted": dict(write_ber=5e-2, retention_ber=1e-2, stuck0_rate=1e-2,
                      stuck1_rate=1e-2, subarray_fail_rate=0.2,
                      subarray_cols=16, protect_msb=3, vote_copies=3),
    "all_voted_4bit": dict(write_ber=5e-2, stuck1_rate=1e-2,
                           subarray_fail_rate=0.2, subarray_cols=16,
                           protect_msb=1, vote_copies=5),
}


@pytest.mark.parametrize("mech", sorted(MECHS))
def test_corrupt_codes_matches_reference(mech):
    bits = 4 if mech.endswith("4bit") else 8
    jpw = _jpw(bits=bits, seed=1)
    jc, tc = _cfgs(seed=5, **MECHS[mech])
    want = JF.corrupt_codes(jpw.codes, bits, jc, jc.key())
    codes = port_pw(jpw).codes
    with TF.use_drawer(JaxDrawer()):
        got = TF.corrupt_codes(codes, bits, tc, tc.key())
        got32 = TF.corrupt_codes(codes.to(torch.int32), bits, tc, tc.key())
    assert got.dtype == torch.uint8 and got32.dtype == torch.int32
    assert_bits_equal(got.to(torch.int32), want)
    assert_bits_equal(got32, want)
    assert (n(want) != n(jpw.codes)).any()


@pytest.mark.parametrize("bits,protect", [(8, 2), (4, 0), (12, 3)])
def test_transient_flip_field_matches_reference(bits, protect):
    jc, tc = _cfgs(read_disturb_ber=3e-2, protect_msb=protect)
    want = JF.transient_flip_field((K, N), bits, jc, jax.random.PRNGKey(7))
    with TF.use_drawer(JaxDrawer()):
        got = TF.transient_flip_field((K, N), bits, tc, TF.Key.root(7))
    assert_bits_equal(got.to(torch.int32), want)
    assert n(want).any()


def test_key_paths_replay_the_reference_keys():
    """Each step kind of a Key (fold_in, split, the engines' chain) lands
    on the reference's key: one draw through each path."""
    from _torch_parity import jax_key

    k = TF.Key.root(3).fold_in(2).split(4, 1).chain(2).chain(1).split(2, 1)
    want = jax.random.PRNGKey(3)
    want = jax.random.split(jax.random.fold_in(want, 2), 4)[1]
    for _ in range(3):
        want = jax.random.split(want)[0]
    want = jax.random.split(want)[1]
    assert np.array_equal(np.asarray(jax_key(k)), np.asarray(want))
    assert k.path[-2] == ("chain", 3)
    assert TF.Key.root(3).seed64() != TF.Key.root(4).seed64()


# -- rendering into every representation --------------------------------------

def _conv_pair():
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((2, 2, 10, N)), jnp.float32)
    return _prepack_conv(w, 8)


def _bank_pair():
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.standard_normal((3, K, N)), jnp.float32)
    return jax.jit(jax.vmap(lambda x: jpacked.prepack(x, 8)))(w)


@pytest.mark.parametrize("kind", ["linear", "conv", "bank"])
def test_inject_packed_matches_reference(kind):
    jpw = {"linear": _jpw, "conv": _conv_pair, "bank": _bank_pair}[kind]()
    jc, tc = _cfgs(write_ber=2e-2, stuck0_rate=5e-3, subarray_fail_rate=0.1,
                   subarray_cols=8, protect_msb=2, seed=11)
    want = JF.inject_packed(jpw, jc, jc.key())
    pw = port_tree(jpw)
    with TF.use_drawer(JaxDrawer()):
        got = TF.inject_packed(pw, tc, tc.key())
    check_pw(got, want)
    clean = pw.mat if kind == "conv" else pw
    assert (n(got.mat.codes if kind == "conv" else got.codes)
            != n(clean.codes)).any()
    assert (got.mat if kind == "conv" else got).codes.dtype == torch.uint8


@pytest.fixture(scope="module")
def lm_trees():
    """A stacked LM tree: 9 layers, ``("attn", "attn", "attn",
    "local_attn")`` (2 reps of a 4-layer unit plus an attn remainder),
    every projection 32 x 32, <8:8>; the port's float init carried to
    JAX, prepacked by the JAX package (jitted), and the same packed arrays
    in the port's layout. (A bank's one site a stage is held by
    ``test_disturbed_bank_matches_reference_vmap``.)"""
    from repro.core import PIMQuantConfig as JP
    from repro.models.lm import ModelConfig as JMC
    from repro.models.lm import model as JM
    from repro_torch.core import PIMQuantConfig as TP
    from repro_torch.models.lm import ModelConfig as TMC
    from repro_torch.models.lm import model as TM

    kw = dict(n_layers=9, d_model=32, n_heads=2, n_kv_heads=2, d_ff=32,
              vocab=32, dtype="float32", local_window=8,
              block_pattern=("attn", "attn", "attn", "local_attn"))
    jcfg = JMC(remat="none", pim=JP(8, 8, backend="int-direct"), **kw)
    tcfg = TMC(pim=TP(8, 8, backend="int-direct"), **kw)
    assert JM.layer_plan(jcfg)[1:] == (2, ("attn",))
    tparams = TM.init(tcfg, torch.Generator().manual_seed(0), device="cpu")

    def to_jax(p):
        if isinstance(p, dict):
            return {k: to_jax(v) for k, v in p.items()}
        if isinstance(p, list):
            return [to_jax(v) for v in p]
        return jnp.asarray(p.numpy())

    jparams = to_jax(tparams)
    jpacked_tree = jax.jit(JM.prepack_params, static_argnums=1)(
        jparams, jcfg.pim)
    return dict(jcfg=jcfg, tcfg=tcfg, jpacked=jpacked_tree,
                tpacked=port_tree(jpacked_tree))


def _walk_pairs(got, want):
    """(port leaf, JAX leaf) for every packed leaf, in walk order."""
    if TF.is_rep_stack(got) or isinstance(got, (tpacked.PackedWeight,
                                                tpacked.PackedConvWeight)):
        yield got, want
        return
    if isinstance(got, dict):
        for k in got:
            yield from _walk_pairs(got[k], want[k])
    elif isinstance(got, (list, tuple)):
        for g, w in zip(got, want):
            yield from _walk_pairs(g, w)


def _lm_like_tree():
    """An LM tree's packed shapes in the JAX package's layout: a scan
    block with a stacked projection (R = 2) and a stacked 3-expert bank
    (2, 3, K, N), a remainder block with a projection and a bank, an
    untied head and float leaves."""
    rng = np.random.default_rng(6)

    def w(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.float32)

    def pk(x):
        fn = functools.partial(jpacked.prepack, w_bits=4)
        for _ in range(x.ndim - 2):
            fn = jax.vmap(fn)
        return jax.jit(fn)(x)

    return {
        "embed": w(8, 4),
        "scan": [{"attn": {"wq": pk(w(2, K, N))},
                  "ffn": {"router": w(2, K, 3), "w_in": pk(w(2, 3, K, N))}}],
        "rest": [{"attn": {"wq": pk(w(K, N))},
                  "ffn": {"router": w(K, 3), "w_in": pk(w(3, K, N))}}],
        "head": pk(w(K, N)),
    }


def test_inject_tree_matches_reference_on_a_stacked_lm_tree():
    """Every leaf's corruption equals the reference's: stacked leaves with
    per-rep keys, the remainder's bank with per-expert keys, the report
    counting a rep list once. A stacked bank nests both; the reference's
    ``inject_packed`` has no branch for 4-d codes (ROADMAP.md, Known
    problems), so it is held against the reference's ``inject_packed``
    of each rep on ``split(leaf_key, R)[r]``, which reaches its
    per-expert branch."""
    jtree = _lm_like_tree()
    ttree = port_tree(jtree)
    jc, tc = _cfgs(write_ber=1e-2, stuck1_rate=2e-3, subarray_fail_rate=0.05,
                   subarray_cols=16, protect_msb=1, seed=4)
    want, wrep = JF.inject_tree(jtree, jc)
    with TF.use_drawer(JaxDrawer()):
        got, rep = TF.inject_tree(ttree, tc)
    assert rep == wrep and rep["injected"] == 5
    pairs = list(_walk_pairs(got, want))
    clean = list(_walk_pairs(ttree, jtree))
    assert len(pairs) == 5
    for i, ((g, w), (_, jclean)) in enumerate(zip(pairs, clean)):
        if isinstance(g, list) and g[0].is_bank:
            ks = jax.random.split(jax.random.fold_in(jc.key(), i), len(g))
            for r, gr in enumerate(g):
                check_pw(gr, JF.inject_packed(
                    jax.tree.map(lambda x, r=r: x[r], jclean), jc, ks[r]))
        else:
            check_pw(g, w)
        assert not isinstance(g, list) or len(g) == 2


def _cnn_like_tree():
    """A CNN tree's packed leaves in the JAX package's layout at 4 bits:
    two convs
    (one with 40 output channels, past a 16-column subarray), an FC and
    float leaves."""
    rng = np.random.default_rng(7)

    def w(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.float32)

    return {"conv1": {"w": _prepack_conv(w(2, 2, 10, N), 4), "b": w(N)},
            "conv2": {"w": _prepack_conv(w(2, 2, 10, 40), 4)},
            "fc": {"w": _prepack(w(K, N), 4), "b": w(N)}}


def test_inject_tree_with_checksum_matches_reference_on_cnn():
    """Corruption of conv (``mat`` and ``fused_planes``) and FC leaves, the
    deploy-time repair and the report equal the reference's, with a
    leaf-wide and a per-subarray spare budget; so does the field-service
    pass (``repair_tree``) against the golden tree."""
    jtree = _cnn_like_tree()
    ttree = port_tree(jtree)
    for sub in (128, 16):
        jc, tc = _cfgs(write_ber=1e-2, checksum=True, spare_cols=4,
                       subarray_cols=sub, seed=8)
        want, wrep = JF.inject_tree(jtree, jc)
        with TF.use_drawer(JaxDrawer()):
            got, rep = TF.inject_tree(ttree, tc)
        assert rep == wrep and rep["repaired_cols"] > 0
        assert rep["bad_cols"] > rep["repaired_cols"]
        for g, w in _walk_pairs(got, want):
            check_pw(g, w)
        again, r2 = TF.repair_tree(got, ttree, 64, sub)
        wagain, wr2 = JF.repair_tree(want, jtree, 64, sub)
        assert r2 == wr2 and r2["repaired_cols"] > 0
        for g, w in _walk_pairs(again, wagain):
            check_pw(g, w)


# -- checksum detection and spare repair --------------------------------------

def test_verify_columns_and_repair_budgets_match_reference():
    """The reference test's scenario: two corrupt columns in each 8-column
    group, a leaf-wide budget of 2 and a per-subarray budget of 1."""
    jpw = _jpw(k=32, nn=16, bits=8)
    codes = np.asarray(jpw.codes).copy()
    for col in (1, 5, 9, 13):
        codes[0, col] += 3
    jbad = jpacked.repack_codes(jpw, jnp.asarray(codes))
    bad = tpacked.repack_codes(port_pw(jpw), t(codes))
    check_pw(bad, jbad)
    assert_bits_equal(TF.verify_columns(bad), JF.verify_columns(jbad))
    for spare, sub in ((2, None), (1, 8), (16, None)):
        got = TF.repair_packed(bad, port_pw(jpw), spare, sub)
        want = JF.repair_packed(jbad, jpw, spare, sub)
        assert got[1:] == want[1:]
        check_pw(got[0], want[0])
        assert_bits_equal(TF.verify_columns(got[0]),
                          JF.verify_columns(want[0]))


def test_verify_columns_flags_exactly_changed_sums():
    """Byte codes sum in int32: a column of 255s past 8 bits of sum is
    flagged only where its sum moved."""
    jpw = _jpw(k=300, nn=16, bits=8)
    pw = port_pw(jpw)
    codes = pw.codes.clone()
    codes[:, 3] = 255
    codes[0, 7] ^= 1
    bad = tpacked.repack_codes(pw, codes)
    flags = TF.verify_columns(bad)
    want = (codes.to(torch.int64).sum(0) != pw.col_sums.to(torch.int64))
    assert torch.equal(flags, want) and flags[3] and flags[7]


# -- transient read disturb ---------------------------------------------------

_BACKENDS = {"int-direct": "int-direct", "mxu-plane": "mxu-plane",
             "popcount": "popcount", "cuda": "pallas"}


def test_disturbed_products_match_reference_on_every_backend():
    """Inside one scope every backend reads the same disturbed state, equal
    to the reference's (its ``pallas`` backend in interpret mode), and the
    same key gives the same product; another key another one."""
    from repro.core import int_matmul_prepacked as jmm
    from repro_torch.core.bitserial import int_matmul_prepacked as tmm

    jpw = _jpw(k=64, nn=32, bits=4)
    pw = port_pw(jpw)
    jc, tc = _cfgs(read_disturb_ber=5e-3, protect_msb=1)
    qa = np.random.default_rng(1).integers(0, 16, size=(8, 64)).astype(
        np.int32)
    clean = n(tmm(t(qa), pw, 4, "popcount"))
    outs = {}
    for tb, jb in _BACKENDS.items():
        with JF.read_disturb_scope(jc, jax.random.PRNGKey(5)):
            want = jmm(jnp.asarray(qa), jpw, 4, backend=jb)
        with TF.use_drawer(JaxDrawer()), \
                TF.read_disturb_scope(tc, TF.Key.root(5)):
            outs[tb] = tmm(t(qa), pw, 4, tb)
        assert_bits_equal(outs[tb], want)
    assert (n(outs["cuda"]) != clean).any()
    with TF.read_disturb_scope(tc, TF.Key.root(6)):
        other = tmm(t(qa), pw, 4, "popcount")
    with TF.read_disturb_scope(tc, TF.Key.root(6)):
        again = tmm(t(qa), pw, 4, "int-direct")
    assert torch.equal(other, again)
    assert (n(other) != n(outs["popcount"])).any()


def test_disturbed_bank_matches_reference_vmap():
    """A bank under a scope takes one (K, N) field for all its experts (the
    reference's ``vmap`` leaves the key unbatched): one site, products
    equal on every backend."""
    from repro.core import int_matmul_prepacked as jmm
    from repro_torch.core.bitserial import int_matmul_prepacked_bank as tmm

    jb = _bank_pair()
    pw = port_pw(jb)
    jc, tc = _cfgs(read_disturb_ber=2e-2)
    qa = np.random.default_rng(4).integers(0, 256, size=(3, 5, 40)).astype(
        np.int32)
    with JF.read_disturb_scope(jc, jax.random.PRNGKey(9)):
        want = jax.vmap(lambda q, w: jmm(q, w, 8, backend="int-direct"))(
            jnp.asarray(qa), jb)
        assert JF._READ_SITE == 1
    for backend in ("int-direct", "mxu-plane", "popcount", "cuda"):
        with TF.use_drawer(JaxDrawer()), \
                TF.read_disturb_scope(tc, TF.Key.root(9)):
            got = tmm(t(qa), pw, 8, backend)
            assert TF.site_mark() == 1
        assert_bits_equal(got, want)


def test_fused_and_im2col_conv_agree_under_disturb():
    """The fused conv's field is drawn in im2col code space, so the fused
    route (kernel 3's plain version) and the im2col product read the same
    disturbed state: equal outputs, equal to the reference's im2col conv
    under the same key, and away from the clean conv."""
    from repro.core import PIMQuantConfig as JP
    from repro.core import pim_conv2d as jconv
    from repro_torch.core import PIMQuantConfig as TP
    from repro_torch.core import pim_conv2d as tconv

    jw = _conv_pair()
    pw = port_tree(jw)
    x = np.random.default_rng(5).standard_normal((2, 9, 9, 10)).astype(
        np.float32)
    jc, tc = _cfgs(read_disturb_ber=1e-2, protect_msb=2)
    cfg = TP(8, 8, backend="cuda")
    outs = {}
    for mode in ("fused", "im2col"):
        with TF.use_drawer(JaxDrawer()), \
                TF.read_disturb_scope(tc, TF.Key.root(3)):
            outs[mode] = tconv(t(x), pw, stride=1, padding=1, cfg=cfg,
                               conv_mode=mode)
            assert TF.site_mark() == 1
    assert torch.equal(outs["fused"], outs["im2col"])
    with JF.read_disturb_scope(jc, jax.random.PRNGKey(3)):
        want = jconv(jnp.asarray(x), jw, stride=1, padding=1,
                     cfg=JP(8, 8, backend="int-direct"))
    np.testing.assert_allclose(n(outs["fused"]), np.asarray(want),
                               rtol=1e-5, atol=1e-5 * float(
                                   np.abs(np.asarray(want)).max()))
    clean = tconv(t(x), pw, stride=1, padding=1, cfg=cfg, conv_mode="fused")
    assert not torch.equal(clean, outs["fused"])


def test_decode_step_read_sites_match_reference(lm_trees):
    """One decode step numbers as many read sites as the reference's traced
    step: every rep of the scan reads at the body's sites, the remainder
    layer and the head at their own."""
    from repro.models.lm import model as JM
    from repro_torch.models.lm import model as TM

    jc, tc = _cfgs(read_disturb_ber=1e-2)
    jcfg, tcfg = lm_trees["jcfg"], lm_trees["tcfg"]
    st = JM.init_state(jcfg, 2, 16)
    with JF.read_disturb_scope(jc, jax.random.PRNGKey(3)):
        jax.jit(lambda p, s: JM.decode_step(
            p, jcfg, jnp.zeros((2, 1), jnp.int32), s)).lower(
                lm_trees["jpacked"], st)
        want = JF._READ_SITE
    drawer = CountingDrawer()
    tst = TM.init_state(tcfg, 2, 16, "cpu")
    with TF.use_drawer(drawer), TF.read_disturb_scope(tc, TF.Key.root(3)):
        TM.decode_step(lm_trees["tpacked"], tcfg,
                       torch.zeros((2, 1), dtype=torch.int32), tst)
        got = TF.site_mark()
    # 4 layers of 7 projections (attention's 4, the MLP's 3) in the scan
    # body (its 2 reps read at the same sites), the remainder's 7, the
    # untied head.
    assert got == want == 4 * 7 + 7 + 1
    # Each site drew once (reps reuse the body's fields): 8 planes a site.
    assert drawer.draws == 8 * got


def test_no_scope_draws_nothing(lm_trees):
    """Outside a scope, and under a scope of a fault-free or
    persistent-only config, a decode step draws nothing and numbers no
    site."""
    from repro_torch.models.lm import model as TM

    drawer = CountingDrawer()
    tcfg = lm_trees["tcfg"]
    for cfg in (None, TF.FaultConfig(), TF.FaultConfig(write_ber=1e-2)):
        tst = TM.init_state(tcfg, 1, 8, "cpu")
        with TF.use_drawer(drawer), TF.read_disturb_scope(cfg,
                                                          TF.Key.root(0)):
            assert not TF.read_disturb_active()
            TM.decode_step(lm_trees["tpacked"], tcfg,
                           torch.zeros((1, 1), dtype=torch.int32), tst)
            assert TF.site_mark() is None
    assert drawer.draws == 0


# -- the cost model's mitigation factors --------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(protect_msb=2), dict(protect_msb=3, vote_copies=5, spare_cols=8),
    dict(protect_msb=12, spare_cols=64, checksum=True)])
@pytest.mark.parametrize("w_bits", [2, 8])
def test_redundancy_factors_and_cost_model_match_reference(kw, w_bits):
    from repro.models.cnn.specs import GemmSpec as JS
    from repro.pim.hierarchy import Geometry as JG
    from repro.pim.mapper import map_gemm as jmap
    from repro_torch.models.cnn.specs import GemmSpec as TS
    from repro_torch.pim.hierarchy import Geometry as TG
    from repro_torch.pim.mapper import map_gemm as tmap

    jc, tc = _cfgs(**kw)
    assert tcm.redundancy_factors(tc, w_bits, 128) == \
        jcm.redundancy_factors(jc, w_bits, 128)
    assert tcm.redundancy_factors(None, w_bits, 128) == \
        jcm.redundancy_factors(None, w_bits, 128)
    jm = jcm.CostModel(JG(), faults=jc, w_bits=w_bits)
    tm = tcm.CostModel(TG(), faults=tc, w_bits=w_bits)
    spec = dict(name="conv2", kind="conv", m=8 * 27 * 27, k=2400, n=256,
                out_elems=8 * 27 * 27 * 256, in_elems=8 * 27 * 27 * 96,
                weight_elems=2400 * 256)
    joc = jmap(JS(**spec), JG(), w_bits, w_bits)
    toc = tmap(TS(**spec), TG(), w_bits, w_bits)
    for fn in ("price_rowops", "price_programs"):
        a, b = getattr(tm, fn)(toc), getattr(jm, fn)(joc)
        assert (a.latency, a.energy) == (b.latency, b.energy)
    plain = tcm.CostModel(TG())
    for fn in ("price_rowops", "price_programs"):
        a = getattr(plain, fn)(toc)
        b = getattr(tcm.CostModel(TG(), faults=None, w_bits=w_bits), fn)(toc)
        assert (a.latency, a.energy) == (b.latency, b.energy)
