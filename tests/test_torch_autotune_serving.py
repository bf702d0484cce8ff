"""The autotuner on the port's engines, against the untuned engines and the
JAX package's tuned engines on the CPU (after the JAX package's
``test_serve_engine_autotune_token_parity`` and
``test_vision_engine_autotune_parity``, at their sizes).

Tuning moves dispatch, never bits: a tuned engine's logits equal the
untuned engine's bit for bit. Against the JAX package's tuned engine the
vision logits agree within the reference test's own ``atol=1e-4``, and LM
greedy tokens are equal (float32 masters; at ``<8:8>`` at one layer, as
the PIM LM path is chaotic deeper, ``ROADMAP.md`` Queue 3). Every packed
leaf carries a decision, the cache file is written, a second engine on the
same file measures nothing, and ``close()`` resets a shared cache.
"""
import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.models.cnn import alexnet as jalexnet
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSamplerConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving.vision import VisionEngine as JVisionEngine
from repro.serving.vision import VisionRequest as JVisionRequest
from repro_torch import convert
from repro_torch.core import PIMQuantConfig
from repro_torch.core.packed import PackedConvWeight, PackedWeight
from repro_torch.launch import serve as tserve
from repro_torch.models.lm import model as M
from repro_torch.pim import autotune as at
from repro_torch.serving import (Request, SamplerConfig, ServeEngine,
                                 VisionEngine, VisionRequest)

from _torch_parity import dense_models, moe_cfgs, moe_params

MAX_LEN = 64
N_NEW = 6
PROMPT_LENS = (5, 13, 21)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _packed(tree) -> list:
    if isinstance(tree, (PackedWeight, PackedConvWeight)):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    return [x for v in items for x in _packed(v)]


def _count_measures(monkeypatch):
    calls = {"n": 0}
    real = at.measure_gemm

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(at, "measure_gemm", counted)
    return calls


# ---------------------------------------------------------------------------
# VisionEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def alexnet():
    """The reference test's AlexNet (64 px, 10 classes) in both packages,
    and four images from a numpy seed."""
    jp = jalexnet.init(jax.random.PRNGKey(0), num_classes=10, image=64)
    imgs = np.random.default_rng(0).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    return dict(jp=jp, tp=convert.params_from_jax(jax.device_get(jp)),
                imgs=imgs)


def _run_vision(eng, req_cls, imgs, precision="<4:4>"):
    for i, im in enumerate(imgs):
        eng.submit(req_cls(rid=i, image=im, model="alexnet",
                           precision=precision))
    return np.stack([c.logits for c in sorted(eng.run(),
                                              key=lambda c: c.rid)])


@pytest.mark.parametrize("backend", ["int-direct", "cuda"])
def test_vision_engine_autotune_parity(alexnet, backend, tmp_path):
    """Buckets of 4, then 2 + 1 (the tuned views keyed per bucket): tuned
    logits equal the untuned port engine's bit for bit, and the JAX
    package's tuned engine's within its test's atol. The JAX engine runs
    op by op (``jax.disable_jit``): its jitted prepack computes some
    AlexNet weight scales an ulp off its eager run, which flips <4:4>
    codes (``ROADMAP.md``, differences), and the port matches eager."""
    imgs = alexnet["imgs"]
    base = VisionEngine({"alexnet": alexnet["tp"]}, backend=backend,
                        max_batch=4, device="cpu")
    want = _run_vision(base, VisionRequest, imgs)
    path = str(tmp_path / "tune.json")
    eng = VisionEngine({"alexnet": alexnet["tp"]}, backend=backend,
                       max_batch=4, autotune="cost", tuning_cache=path,
                       device="cpu")
    got = _run_vision(eng, VisionRequest, imgs)
    assert np.array_equal(got, want)
    assert np.array_equal(_run_vision(eng, VisionRequest, imgs[:3]),
                          _run_vision(base, VisionRequest, imgs[:3]))
    jeng = JVisionEngine({"alexnet": alexnet["jp"]}, backend="int-direct",
                         max_batch=4, autotune="cost")
    with jax.disable_jit():
        want_jax = _run_vision(jeng, JVisionRequest, imgs)
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=1e-4)
    jeng.close()
    assert len(eng.tune_cache) > 0 and os.path.exists(path)
    assert sorted(eng._tuned) == [("alexnet", "<4:4>", 64, 64, n)
                                  for n in (1, 2, 4)]
    for tree in eng._tuned.values():
        leaves = _packed(tree)
        assert leaves and all(leaf.tune is not None for leaf in leaves)
        assert all(leaf.mat.tune is not None for leaf in leaves
                   if isinstance(leaf, PackedConvWeight))
        # On the CPU no candidate is "cuda" (its plain version is no
        # contender): the library backends only.
        assert {leaf.tune.backend for leaf in leaves} <= \
            set(at.LIBRARY_BACKENDS)
    eng.close()


def test_vision_engine_second_deploy_reads_the_cache(alexnet, tmp_path,
                                                     monkeypatch):
    """``measure`` times the FC candidates once (the convs rank by cost,
    as in the reference); a second engine on the same file decides
    everything from it, timing nothing, with the same picks and logits."""
    calls = _count_measures(monkeypatch)
    path = str(tmp_path / "tune.json")
    kw = dict(backend="int-direct", max_batch=4, autotune="measure",
              tuning_cache=path, device="cpu")
    eng = VisionEngine({"alexnet": alexnet["tp"]}, **kw)
    first = _run_vision(eng, VisionRequest, alexnet["imgs"])
    assert calls["n"] > 0
    calls["n"] = 0
    again = VisionEngine({"alexnet": alexnet["tp"]}, **kw)
    assert np.array_equal(_run_vision(again, VisionRequest,
                                      alexnet["imgs"]), first)
    assert calls["n"] == 0
    picks = {k: at.TuningCache(path).get(k) for k in eng.tune_cache.entries}
    assert picks == {k: e["decision"]
                     for k, e in again.tune_cache.entries.items()}
    assert {e["mode"] for e in again.tune_cache.entries.values()} == \
        {"cost", "measure"}


def test_vision_engine_close_resets_a_shared_cache(alexnet, tmp_path):
    path = str(tmp_path / "tune.json")
    open(path, "w").write("{ corrupt")
    with pytest.warns(RuntimeWarning, match="falling back"):
        cache = at.TuningCache(path)
    eng = VisionEngine({"alexnet": alexnet["tp"]}, backend="int-direct",
                       max_batch=4, autotune="cost", tuning_cache=cache,
                       device="cpu")
    _run_vision(eng, VisionRequest, alexnet["imgs"][:1])
    assert eng.tune_cache is cache and len(cache) > 0
    eng.close()
    assert not cache._warned and len(cache) > 0


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen3-0.6b, float32, one set of weights in both packages
    (first layer only, for the chaotic <8:8> path), and the prompts."""
    d = dense_models(("qwen3-0.6b",))["qwen3-0.6b"]
    jc, tc = (dataclasses.replace(c, n_layers=1) for c in (d["jc"], d["tc"]))
    jp = dict(d["jp"], scan=[jax.tree.map(lambda x: x[:1],
                                          d["jp"]["scan"][0])])
    prompts = [np.random.default_rng(30 + i).integers(
        0, tc.vocab, size=n).astype(np.int32)
        for i, n in enumerate(PROMPT_LENS)]
    return dict(jc=jc, tc=tc, jp=jp, tp=convert.params_from_jax(jp),
                full=d, prompts=prompts)


def _serve(cfg, params, prompts, **kw):
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      sampler=SamplerConfig(temperature=0.0), device="cpu",
                      **kw)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=N_NEW))
    return {c.rid: c.tokens for c in eng.run(strict=True)}, eng


def _serve_jax(cfg, params, prompts, **kw):
    eng = JServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                       sampler=JSamplerConfig(temperature=0.0), **kw)
    for rid, p in enumerate(prompts):
        eng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=N_NEW))
    done = {c.rid: c.tokens for c in eng.run()}
    eng.close()
    return done


def _prefill_logits(eng, cfg, prompt):
    with torch.no_grad():
        st = M.init_state(cfg, 1, MAX_LEN, "cpu")
        return M.prefill(eng.params, cfg, torch.from_numpy(prompt)[None],
                         st)[0]


@pytest.mark.parametrize("backend", ["popcount", "cuda"])
def test_serve_engine_autotune_token_parity(qwen, backend, tmp_path):
    """<8:8> at one layer: the tuned engine's tokens and prefill logits
    equal the untuned engine's bit for bit, its tokens equal the JAX
    package's tuned engine's; every packed leaf carries a decision and the
    cache file is written."""
    pim = PIMQuantConfig(8, 8, backend=backend)
    tc = dataclasses.replace(qwen["tc"], pim=pim)
    jc = dataclasses.replace(qwen["jc"], pim=JPIMQuantConfig(
        8, 8, backend="popcount"))
    base, beng = _serve(tc, qwen["tp"], qwen["prompts"])
    path = str(tmp_path / "tune.json")
    got, eng = _serve(tc, qwen["tp"], qwen["prompts"], autotune="cost",
                      tuning_cache=path)
    assert got == base
    assert torch.equal(_prefill_logits(eng, tc, qwen["prompts"][2]),
                       _prefill_logits(beng, tc, qwen["prompts"][2]))
    assert got == _serve_jax(jc, qwen["jp"], qwen["prompts"],
                             autotune="cost")
    leaves = _packed(eng.params)
    assert leaves and all(leaf.tune is not None for leaf in leaves)
    assert {leaf.tune.backend for leaf in leaves} <= set(at.LIBRARY_BACKENDS)
    assert os.path.exists(path) and len(eng.tune_cache) > 0
    assert all(k.startswith(f"gemm:{2}x") for k in eng.tune_cache.entries)


def test_serve_engine_float32_tokens_equal_jax_tuned(qwen):
    """Float32 masters at the reduced depth: autotune has no packed weight
    to tune, and the tokens equal the JAX package's tuned engine's."""
    d = qwen["full"]
    got, eng = _serve(d["tc"], d["tp"], qwen["prompts"], autotune="cost")
    assert got == _serve_jax(d["jc"], d["jp"], qwen["prompts"],
                             autotune="cost")
    assert eng.tune_cache is None and not _packed(eng.params)


def test_serve_engine_measure_then_cache(qwen, tmp_path, monkeypatch):
    """``measure`` times each distinct projection shape's candidates once;
    a second engine on the same file times nothing and decides alike."""
    calls = _count_measures(monkeypatch)
    tc = dataclasses.replace(qwen["tc"], pim=PIMQuantConfig(
        8, 8, backend="int-direct"))
    path = str(tmp_path / "tune.json")
    got, eng = _serve(tc, qwen["tp"], qwen["prompts"], autotune="measure",
                      tuning_cache=path)
    shapes = {leaf.codes.shape for leaf in _packed(eng.params)}
    assert calls["n"] == len(shapes) * len(at.LIBRARY_BACKENDS)
    calls["n"] = 0
    again, eng2 = _serve(tc, qwen["tp"], qwen["prompts"],
                         autotune="measure", tuning_cache=path)
    assert calls["n"] == 0 and again == got
    assert [leaf.tune for leaf in _packed(eng2.params)] == \
        [leaf.tune for leaf in _packed(eng.params)]


def test_serve_engine_close_resets_a_shared_cache(qwen, tmp_path):
    path = str(tmp_path / "tune.json")
    open(path, "w").write("{ corrupt")
    with pytest.warns(RuntimeWarning, match="falling back"):
        cache = at.TuningCache(path)
    tc = dataclasses.replace(qwen["tc"], pim=PIMQuantConfig(
        4, 4, backend="popcount"))
    eng = ServeEngine(tc, qwen["tp"], max_batch=2, max_len=32,
                      autotune="cost", tuning_cache=cache, device="cpu")
    assert eng.tune_cache is cache
    assert len(cache) > 0              # tuning healed the file on save
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.close()
    assert not cache._warned and len(cache) > 0


def test_moe_engine_tunes_banks_at_capacity_rows():
    """phi3.5-moe, reduced, <8:8>, one layer: the banks decide at every
    expert's capacity rows (``moe_m_hint``) on the library backends, and
    the tuned engine's tokens equal the untuned engine's."""
    from repro_torch.models.lm.moe import _capacity

    jc, tc = moe_cfgs(n_layers=1)
    _, tp = moe_params(jc, seed=1)
    tc = dataclasses.replace(tc, pim=PIMQuantConfig(8, 8, backend="cuda"))
    prompts = [np.random.default_rng(60 + i).integers(
        0, tc.vocab, size=n).astype(np.int32) for i, n in enumerate((11, 5))]
    base, _ = _serve(tc, tp, prompts)
    got, eng = _serve(tc, tp, prompts, autotune="cost")
    assert got == base
    rows = tc.moe.n_experts * _capacity(2, tc)
    banks = [leaf for leaf in _packed(eng.params) if leaf.is_bank]
    assert banks and all(leaf.tune is not None for leaf in banks)
    e, k, n = banks[0].codes.shape
    assert at.gemm_key(rows, k, n, 8, 8, at.LIBRARY_BACKENDS) in \
        eng.tune_cache.entries


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_takes_autotune_and_a_tuning_cache(capsys, tmp_path):
    lm_path, cnn_path = str(tmp_path / "lm.json"), str(tmp_path / "cnn.json")
    tserve.main(["--workload", "lm", "--arch", "qwen3-0.6b", "--reduced",
                 "--device", "cpu", "--precision", "<8:8>", "--backend",
                 "int-direct", "--requests", "2", "--max-new", "3",
                 "--autotune", "cost", "--tuning-cache", lm_path])
    tserve.main(["--workload", "cnn", "--cnn-model", "alexnet", "--image",
                 "64", "--classes", "10", "--requests", "2", "--device",
                 "cpu", "--autotune", "cost", "--tuning-cache", cnn_path])
    out = capsys.readouterr().out
    assert "2 completions" in out and "2 images" in out
    assert len(at.TuningCache(lm_path)) > 0
    assert len(at.TuningCache(cnn_path)) > 0
