"""The port's autotuner (``repro_torch.pim.autotune``) against the JAX
package's (``repro.pim.autotune``) on the CPU, and its own contract.

Parity: on the same shapes the analytic costs of the library backends are
equal (``==``: both are the same host arithmetic on the same mapper and
price list), and so are the cost-mode decisions without the tie-break
(``hlo_tiebreak=False``: the JAX package breaks near-ties on compiled HLO,
the port on its own roofline count), the cache keys, the conv decisions at
AlexNet's and ResNet-50's convs, and ``tune_tree``'s decision at every
packed leaf of the reduced AlexNet, ResNet-50 and phi3.5-moe trees (a
scanned layer's per-rep weights each against the JAX stacked leaf).

Contract (after the JAX package's tests/test_autotune.py): tuning moves
dispatch, never bits (every candidate, each legalized kernel-2 tile
request among them, gives the untuned P); the cache is fail-safe (an
unusable file falls back with one warning, no retune storm) and round
trips; a decision survives every device move; the tile requests are
legalized into launch plans the kernel takes.
"""
import dataclasses
import functools
import importlib.util
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.packed import PackedConvWeight as JPackedConvWeight
from repro.core.packed import PackedWeight as JPackedWeight
from repro.core.packed import TuneDecision as JTuneDecision
from repro.pim import autotune as jat
from repro_torch import convert
from repro_torch.core import PIMQuantConfig
from repro_torch.core.bitserial import (int_matmul_prepacked,
                                        int_matmul_prepacked_bank)
from repro_torch.core.packed import (PackedConvWeight, PackedWeight,
                                     TuneDecision, prepack, prepack_conv)
from repro_torch.core.pim_layers import pim_conv2d
from repro_torch.kernels import bitserial_matmul as bsm
from repro_torch.kernels import ops
from repro_torch.models.lm import model as M
from repro_torch.pim import autotune as at

from _torch_parity import moe_cfgs, moe_params

_REPO = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()

# benchmarks/autotune_bench.py's SHAPES (kept here, as chip_smoke.py keeps
# them) and the JAX package's awkward shapes: prime K / N, N below one
# tile, N just over one.
BENCH_SHAPES = [(4, 2048, 2048), (8, 4096, 1024), (64, 8192, 512),
                (256, 2048, 256), (1024, 512, 1024)]
AWKWARD = [(4, 64, 128), (5, 67, 33), (8, 96, 130)]
BITS = [2, 4, 8]


def _operands(m, k, n, bits, seed=0):
    rng = np.random.default_rng(seed)
    qa = torch.from_numpy(rng.integers(0, 2 ** bits, (m, k)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return qa, prepack(w, bits)


def _no_tiebreak(mod, monkeypatch):
    """Make ``mod.decide_gemm`` rank without the tie-break, wherever it is
    called from (``tune_tree`` reads the module's global)."""
    monkeypatch.setattr(mod, "decide_gemm", functools.partial(
        mod.decide_gemm, hlo_tiebreak=False))


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", BENCH_SHAPES + AWKWARD[1:])
@pytest.mark.parametrize("bits", BITS)
def test_costs_decisions_and_keys_equal_jax(m, k, n, bits):
    for be in at.LIBRARY_BACKENDS:
        assert at.analytic_gemm_cost(m, k, n, bits, bits, TuneDecision(be)) \
            == jat.analytic_gemm_cost(m, k, n, bits, bits, JTuneDecision(be))
    for ab, wb in ((bits, bits), (bits, 8)):
        got = at.decide_gemm(m, k, n, ab, wb, hlo_tiebreak=False)
        want = jat.decide_gemm(m, k, n, ab, wb, hlo_tiebreak=False)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert at.gemm_key(m, k, n, ab, wb, at.LIBRARY_BACKENDS) == \
            jat.gemm_key(m, k, n, ab, wb, jat.XLA_BACKENDS)


_CONVS = {model: _SMOKE.SERVED_CONVS[model] for model in ("alexnet",
                                                           "resnet50")}
# ResNet-50's 1x1 convs (where im2col is a reshape), stride 1 and 2.
_CONVS["resnet50"] = _CONVS["resnet50"] + [
    (55, 64, 64, 1, 1, 0), (55, 64, 256, 1, 1, 0), (55, 256, 128, 1, 2, 0),
    (28, 512, 256, 1, 2, 0), (7, 2048, 512, 1, 1, 0)]


@pytest.mark.parametrize("model", sorted(_CONVS))
@pytest.mark.parametrize("bits", BITS)
def test_decide_conv_and_conv_key_equal_jax(model, bits):
    """Library backends: the same pair; "cuda" in the set: the pair the
    JAX package picks with "pallas" there, "cuda" in its place."""
    for h, c, o, k, s, p in _CONVS[model]:
        kw = dict(stride=s, padding=p, a_bits=bits, w_bits=bits)
        got = at.decide_conv(8, h, h, c, o, k, k, **kw)
        want = jat.decide_conv(8, h, h, c, o, k, k, **kw)
        assert [dataclasses.asdict(d) for d in got] == \
            [dataclasses.asdict(d) for d in want]
        got = at.decide_conv(8, h, h, c, o, k, k, backends=at.ALL_BACKENDS,
                             **kw)
        want = jat.decide_conv(8, h, h, c, o, k, k,
                               backends=jat.ALL_BACKENDS, **kw)
        assert [dataclasses.asdict(d) for d in got] == [
            dict(dataclasses.asdict(d), backend=d.backend.replace(
                "pallas", "cuda")) for d in want]
        assert at.conv_key(8, h, h, c, o, k, k, s, p, bits, bits,
                           at.LIBRARY_BACKENDS) == jat.conv_key(
            8, h, h, c, o, k, k, s, p, bits, bits, jat.XLA_BACKENDS)


def _jax_leaves(tree):
    """{path: packed leaf} of a tuned JAX tree, paths as dict keys and
    list indices."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JPackedWeight,
                                               JPackedConvWeight)))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): x
            for p, x in leaves
            if isinstance(x, (JPackedWeight, JPackedConvWeight))}


def _port_leaves(tree, path=()):
    if isinstance(tree, (PackedWeight, PackedConvWeight)):
        return {path: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for k, v in items:
        out.update(_port_leaves(v, path + (k,)))
    return out


def _assert_same_decisions(tuned, jtuned):
    want = _jax_leaves(jtuned)
    got = _port_leaves(tuned)
    assert got and want
    seen = set()
    for path, leaf in got.items():
        # A scanned layer's per-rep list entry against the stacked leaf.
        jpath = path if path in want else path[:-1]
        jleaf = want[jpath]
        seen.add(jpath)
        assert dataclasses.asdict(leaf.tune) == \
            dataclasses.asdict(jleaf.tune), path
        if isinstance(leaf, PackedConvWeight):
            assert dataclasses.asdict(leaf.mat.tune) == \
                dataclasses.asdict(jleaf.mat.tune), path
    assert seen == set(want)


@pytest.fixture(scope="module")
def cnn_trees():
    from repro.core import PIMQuantConfig as JPIMQuantConfig
    from repro.models.cnn import alexnet as jalexnet
    from repro.models.cnn import resnet as jresnet
    from repro_torch.models.cnn import alexnet, resnet

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresnet, "_STAGES", [(1, 64), (2, 128)])
        mp.setattr(resnet, "_STAGES", [(1, 64), (2, 128)])
        for name, jmod, tmod in (("alexnet", jalexnet, alexnet),
                                 ("resnet50", jresnet, resnet)):
            jp = jmod.init(jax.random.PRNGKey(0), num_classes=10, image=64)
            tp = convert.params_from_jax(jax.device_get(jp))
            out[name] = (
                jmod.prepack(jp, JPIMQuantConfig(8, 8, backend="int-direct")),
                tmod.prepack(tp, PIMQuantConfig(8, 8, backend="int-direct")))
    return out


@pytest.mark.parametrize("model", ["alexnet", "resnet50"])
def test_tune_tree_matches_jax_on_cnn_trees(cnn_trees, model, monkeypatch):
    jtree, tree = cnn_trees[model]
    _no_tiebreak(jat, monkeypatch)
    _no_tiebreak(at, monkeypatch)
    kw = dict(m_hint=4, a_bits=8, conv_m_hint=4 * 64 * 64)
    tuned = at.tune_tree(tree, **kw)
    _assert_same_decisions(tuned, jat.tune_tree(jtree, **kw))
    # The tuned tree holds the same tensors: attaching copies nothing.
    for path, leaf in _port_leaves(tree).items():
        new = _port_leaves(tuned)[path]
        assert (new.mat if isinstance(new, PackedConvWeight) else new
                ).codes is (leaf.mat if isinstance(leaf, PackedConvWeight)
                            else leaf).codes


def test_tune_tree_matches_jax_on_a_moe_tree(monkeypatch):
    """phi3.5-moe, reduced, <8:8>: attention projections and the head
    rank every candidate at the token batch, the expert banks the library
    backends at every expert's capacity rows (``moe_m_hint``)."""
    from repro.core import PIMQuantConfig as JPIMQuantConfig
    from repro.models.lm import model as jM
    from repro.models.lm.moe import _capacity as jcapacity
    from repro_torch.models.lm.moe import _capacity

    jc, tc = moe_cfgs()
    jp, tp = moe_params(jc)
    jtree = jM.prepack_params(jp, JPIMQuantConfig(8, 8,
                                                  backend="int-direct"))
    tree = M.prepack_params(tp, PIMQuantConfig(8, 8, backend="int-direct"))
    _no_tiebreak(jat, monkeypatch)
    _no_tiebreak(at, monkeypatch)
    moe_m = tc.moe.n_experts * _capacity(4, tc)
    assert moe_m == jc.moe.n_experts * jcapacity(4, jc)
    kw = dict(m_hint=4, a_bits=8, moe_m_hint=moe_m)
    tuned = at.tune_tree(tree, **kw)
    _assert_same_decisions(tuned, jat.tune_tree(jtree, **kw))
    banks = [leaf for path, leaf in _port_leaves(tuned).items()
             if at._is_expert_path(path)]
    assert banks and all(b.is_bank for b in banks)
    # With "cuda" in the set, the banks still rank the library backends.
    cuda = at.tune_tree(tree, backends=at.ALL_BACKENDS, **kw)
    assert all(leaf.tune.backend != "cuda"
               for path, leaf in _port_leaves(cuda).items()
               if at._is_expert_path(path))


# ---------------------------------------------------------------------------
# Tuning moves dispatch, never bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", AWKWARD)
@pytest.mark.parametrize("bits", BITS)
def test_every_candidate_gives_the_untuned_product(m, k, n, bits):
    """All four backends and every legalized kernel-2 tile request (their
    plain versions here), and kernel 4 at tile requests: the same P."""
    qa, pk = _operands(m, k, n, bits)
    ref = int_matmul_prepacked(qa, pk, bits, "popcount")
    cands = at.gemm_candidates(m, k, n, bits, bits, backends=at.ALL_BACKENDS)
    assert {d.backend for d in cands} == set(at.ALL_BACKENDS)
    cands += [TuneDecision("popcount", bm=64, bn=128, bkw=32),
              TuneDecision("cuda", bm=8, bn=512, bkw=5000)]
    for d in cands:
        assert torch.equal(int_matmul_prepacked(qa, at.attach(pk, d), bits),
                           ref), d


def test_decision_overrides_config_backend():
    qa, pk = _operands(4, 64, 128, 4)
    tuned = at.attach(pk, TuneDecision(backend="int-direct"))
    ref = int_matmul_prepacked(qa, pk, 4, "popcount")
    assert torch.equal(int_matmul_prepacked(qa, tuned, 4, "popcount"), ref)
    # The decision is what dispatches: an unknown call-site backend is
    # never read.
    assert torch.equal(int_matmul_prepacked(qa, tuned, 4, "no-such"), ref)
    with pytest.raises(ValueError, match="backend"):
        int_matmul_prepacked(qa, pk, 4, "no-such")


def test_a_bank_reads_its_decision():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((3, 70, 40)).astype(np.float32))
    qa = torch.from_numpy(rng.integers(0, 16, (3, 5, 70)).astype(np.int32))
    bank = prepack(w, 4)
    ref = int_matmul_prepacked_bank(qa, bank, 4, "int-direct")
    for d in (TuneDecision("popcount", bm=64, bkw=4), TuneDecision("cuda"),
              TuneDecision("mxu-plane")):
        got = int_matmul_prepacked_bank(qa, at.attach(bank, d), 4, "no-such")
        assert torch.equal(got, ref), d


def test_conv_decision_steers_pim_conv2d(monkeypatch):
    """A conv-level decision resolves ``conv_mode="auto"`` and hands its O
    block to kernel 3; an explicit ``conv_mode`` wins; the im2col
    product's backend rides on ``mat.tune``. The output never moves."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 5, 7)).astype(np.float32))
    cfg = PIMQuantConfig(4, 4, backend="int-direct")
    pw = prepack_conv(w, 4)
    ref = pim_conv2d(x, pw, stride=1, padding=1, cfg=cfg)
    seen = []
    real = ops.conv2d_bitserial

    def spy(*a, **k):
        seen.append(k.get("bo"))
        return real(*a, **k)

    monkeypatch.setattr(ops, "conv2d_bitserial", spy)
    fused = at.attach_conv(pw, TuneDecision("cuda", conv_mode="fused",
                                            bo=128))
    assert torch.equal(pim_conv2d(x, fused, padding=1, cfg=cfg), ref)
    assert seen == [128]
    assert torch.equal(pim_conv2d(x, fused, padding=1, cfg=cfg,
                                  conv_mode="im2col"), ref)
    assert seen == [128]
    im2col = at.attach_conv(pw, TuneDecision("mxu-plane",
                                             conv_mode="im2col"),
                            mat=TuneDecision("popcount", bm=64, bkw=8))
    assert torch.equal(pim_conv2d(x, im2col, padding=1, cfg=cfg), ref)
    assert seen == [128]
    # ops.conv2d_bitserial takes the reference's bo and legalizes it.
    qx = torch.from_numpy(rng.integers(0, 16, (2, 11, 11, 5)).astype(
        np.int32))
    assert torch.equal(real(qx, pw.fused_planes, a_bits=4, bo=256),
                       real(qx, pw.fused_planes, a_bits=4))


def test_tune_survives_device_moves_and_casts():
    d = TuneDecision("cuda", bm=16, bn=128, bkw=32)
    _, pk = _operands(4, 64, 128, 8)
    pk = at.attach(pk, d)
    pcw = at.attach_conv(prepack_conv(torch.randn(3, 3, 4, 8), 8),
                         TuneDecision("cuda", conv_mode="fused", bo=64),
                         mat=d)
    assert pk.to("cpu").tune == d
    moved = pcw.to("cpu")
    assert moved.tune == pcw.tune and moved.mat.tune == d
    tree = {"scan": [{"wq": [pk, pk]}], "head": pk,
            "norm": torch.ones(4, 4)}
    for out in (M.to_device(tree, "cpu"),
                M.cast_params(tree, torch.bfloat16)):
        assert all(leaf.tune == d for leaf in
                   [*out["scan"][0]["wq"], out["head"]])
    assert M.cast_params(tree, torch.bfloat16)["norm"].dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# Tile requests -> launch plans
# ---------------------------------------------------------------------------

def test_matmul_tiles_legalizes_requests():
    assert ops.matmul_tiles(4, 2048, 64, 8, 8) == (16, 128, None)
    assert ops.matmul_tiles(300, 2048, 64, 8, 8) == (64, 128, None)
    assert ops.matmul_tiles(300, 2048, 64, 8, 8, 8, 512, 32) == (16, 128, 32)
    assert ops.matmul_tiles(4, 2048, 64, 8, 8, 256, 256, 33) == (64, 128, 36)
    assert ops.matmul_tiles(4, 2048, 64, 8, 8, None, None, 512) == \
        (16, 128, 64)                           # capped at K
    assert ops.matmul_tiles(4, 8, 5000, 8, 8, bkw=4096) == \
        (16, 128, bsm.SLAB_WORDS)               # capped at one slab
    assert ops.matmul_tiles(4, 8, 3, 8, 8, bkw=1) == (16, 128, 4)


@pytest.mark.parametrize("m", [1, 5, 16, 17, 64, 300])
def test_plans_at_tile_requests_are_launchable(m):
    """Every request gives a plan the C entry takes (its splits tile [0,
    KW), each a whole number of the tile's 4-word steps, at most one slab;
    the grid's z within 65,535), and no request leaves today's plan."""
    for n in (8, 131, 4096):
        for kw in (1, 3, 4, 5, 100, 1024, 1025, 5000):
            for e in (1, 16):
                assert bsm._plan(m, n, kw, 132, e) == \
                    bsm._plan(m, n, kw, 132, e, None, None)
                for bm in (None, 8, 16, 64, 256):
                    for bkw in (None, 1, 3, 4, 32, 5000):
                        p = bsm._plan(m, n, kw, 132, e, bm, bkw)
                        ks = bsm.TILES[p.variant][2]
                        assert p.split_words % ks == 0
                        assert ks <= p.split_words <= bsm.SLAB_WORDS
                        assert (p.splits - 1) * p.split_words < kw \
                            <= p.splits * p.split_words
                        assert e * p.splits <= 65535
                        if bm is not None:
                            assert p.variant == (bsm.SMALL if bm <= 16
                                                 else bsm.LARGE)


def test_tile_factor_ranks_the_untuned_plan_first_at_decode():
    """At a decode shape the plan's own split (two blocks an SM) is the
    analytic pick among kernel 2's candidates."""
    cands = [d for d in at.gemm_candidates(4, 3072, 3072, 8, 8, ("cuda",))]
    best = min(cands, key=lambda d: at._tile_factor(4, 3072, 3072, 8, 8, d))
    assert (best.bm, best.bkw) == (16, None)
    assert at._tile_factor(4, 3072, 3072, 8, 8, best) == 1.0


# ---------------------------------------------------------------------------
# The tuning cache (after the JAX package's tests)
# ---------------------------------------------------------------------------

def _count_ranks(monkeypatch):
    calls = {"n": 0}
    real = at.gemm_candidates

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(at, "gemm_candidates", counted)
    return calls


@pytest.mark.parametrize("blob", [
    "{ this is not json",                       # corrupt
    '{"version": 1, "code_version": "x", "ent', # truncated
    json.dumps({"version": 99, "code_version": "x", "entries": {}}),
    json.dumps({"version": 1, "code_version": "stale", "entries": {}}),
    "bad entry",
])
def test_unusable_cache_falls_back_with_single_warning(tmp_path, blob,
                                                       monkeypatch):
    if blob == "bad entry":
        blob = json.dumps({"version": 1, "code_version": at.code_version(),
                           "entries": {"k": {"decision": {"bm": 8}}}})
    path = tmp_path / "tune.json"
    path.write_text(blob)
    calls = _count_ranks(monkeypatch)
    with pytest.warns(RuntimeWarning, match="falling back to cost-model"):
        cache = at.TuningCache(str(path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a second warning would fail
        d1 = at.decide_gemm(4, 64, 128, 4, 4, cache=cache,
                            hlo_tiebreak=False)
        for _ in range(5):
            assert at.decide_gemm(4, 64, 128, 4, 4, cache=cache,
                                  hlo_tiebreak=False) == d1
    assert calls["n"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fresh = at.TuningCache(str(path))
    assert fresh.get(at.gemm_key(4, 64, 128, 4, 4, at.LIBRARY_BACKENDS)) == d1


def test_cache_persists_and_round_trips(tmp_path):
    path = str(tmp_path / "tune.json")
    c1 = at.TuningCache(path)
    d = at.decide_gemm(8, 96, 130, 8, 8, cache=c1, hlo_tiebreak=False)
    pair = at.decide_conv(2, 9, 9, 5, 7, 3, 3, padding=1, cache=c1)
    c2 = at.TuningCache(path)
    assert c2.get(at.gemm_key(8, 96, 130, 8, 8, at.LIBRARY_BACKENDS)) == d
    assert c2.get(at.conv_key(2, 9, 9, 5, 7, 3, 3, 1, 1, 8, 8,
                              at.LIBRARY_BACKENDS)) == pair
    blob = json.load(open(path))
    assert blob["version"] == at.TuningCache.VERSION
    assert blob["code_version"] == at.code_version()
    assert not Path(f"{path}.tmp").exists()     # written, then renamed


def test_cache_extra_round_trip():
    """Decisions survive a snapshot manifest's JSON ``extra`` dict."""
    cache = at.TuningCache(None)
    d = at.decide_gemm(4, 64, 128, 4, 4, cache=cache, hlo_tiebreak=False)
    extra = json.loads(json.dumps({"tuning": cache.to_extra()}))
    fresh = at.TuningCache(None)
    fresh.merge_extra(extra["tuning"])
    assert fresh.get(at.gemm_key(4, 64, 128, 4, 4, at.LIBRARY_BACKENDS)) == d


def test_stale_snapshot_extra_dropped_with_warning():
    cache = at.TuningCache(None)
    with pytest.warns(RuntimeWarning, match="falling back"):
        cache.merge_extra({"version": 1, "code_version": "stale",
                           "entries": {}})
    assert len(cache) == 0


def test_reset_reloads_repaired_file_and_rearms_warning(tmp_path):
    path = str(tmp_path / "tune.json")
    good = at.TuningCache(path)
    d = at.decide_gemm(4, 64, 128, 4, 4, cache=good, hlo_tiebreak=False)
    key = at.gemm_key(4, 64, 128, 4, 4, at.LIBRARY_BACKENDS)
    blob = open(path).read()
    open(path, "w").write("{ corrupt")
    with pytest.warns(RuntimeWarning, match="falling back"):
        cache = at.TuningCache(path)
    assert cache.get(key) is None and cache._warned
    open(path, "w").write(blob)        # repair on disk
    assert cache.get(key) is None      # stale memo: still empty, silent
    cache.reset()
    assert cache.get(key) == d
    assert not cache._warned


@pytest.mark.parametrize("name", ["bitplane_pack", "bitserial_matmul",
                                  "conv2d_fused"])
def test_code_version_covers_each_kernel_source(tmp_path, monkeypatch, name):
    """Each kernel the backends launch (kernel 1 packs popcount's
    activations) stales the cache when its own source is edited."""
    from repro_torch.kernels import _build

    copies = {}
    for src in ("bitplane_pack", "bitserial_matmul", "conv2d_fused"):
        copies[src] = tmp_path / f"{src}.cu"
        copies[src].write_bytes((_build.SRC_DIR / f"{src}.cu").read_bytes())
    monkeypatch.setattr(_build, "_sources", lambda n: [copies[n]])
    at.code_version.cache_clear()
    try:
        before = at.code_version()
        copies[name].write_text(copies[name].read_text() + "\n// edited\n")
        at.code_version.cache_clear()
        assert at.code_version() != before
    finally:
        at.code_version.cache_clear()


def test_measure_mode_uses_injected_measurer():
    times = {"popcount": 3.0, "mxu-plane": 2.0, "int-direct": 1.0}
    d = at.decide_gemm(8, 256, 256, 4, 4, mode="measure",
                       measure=lambda dec, *a: times[dec.backend],
                       hlo_tiebreak=False)
    assert d.backend == "int-direct"
    d2 = at.decide_gemm(8, 256, 256, 4, 4, mode="measure",
                        measure=lambda dec, *a: None, hlo_tiebreak=False)
    assert d2 == at.decide_gemm(8, 256, 256, 4, 4, hlo_tiebreak=False)


def test_measure_gemm_times_on_the_cpu_and_drops_a_refusal():
    t = at.measure_gemm(TuneDecision("int-direct"), 4, 64, 128, 4, 4,
                        device="cpu")
    assert t is not None and t > 0
    # The kernels' wrappers take 1..8 bits: a 9-bit candidate is dropped.
    assert at.measure_gemm(TuneDecision("popcount"), 4, 64, 128, 9, 9) is None
    times = {}

    def measure(d, *a):
        times[d.backend] = at.measure_gemm(d, *a)
        return times[d.backend]

    d = at.decide_gemm(4, 64, 128, 9, 9, mode="measure", measure=measure,
                       hlo_tiebreak=False)
    assert times["popcount"] is None and d.backend != "popcount"


def test_a_kernel_failure_is_not_dropped(monkeypatch):
    """Only refusals drop a candidate: any other failure propagates, so
    no fallback hides a kernel that does not build or launch."""
    def broken(*a, **k):
        raise RuntimeError("CUDA kernel build failed")

    monkeypatch.setattr(ops, "bitserial_matmul_packed", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        at.measure_gemm(TuneDecision("popcount"), 4, 64, 128, 4, 4)


def test_device_kind_and_candidate_sets():
    assert at.device_kind() == at.device_kind("cpu") == "cpu"
    assert at.default_backends("cpu") == at.LIBRARY_BACKENDS
    cuda = torch.device("cuda")
    assert at.default_backends(cuda) == at.ALL_BACKENDS
    assert at._rates(cuda) is at._RATES["cuda"]
    assert at._rates("cpu") == dict(
        {k: v for k, v in jat._RATES["default"].items() if k != "pallas"},
        cuda=jat._RATES["default"]["pallas"])
