"""Self-healing serving and the fault-tolerant step loop of the port against
the JAX package: ``StragglerDetector``, ``RestartPolicy``,
``run_resilient``; ``ServeEngine`` under faults, a watchdog and an
injector (rollback and retry, transient read disturb replayed, degrade to
the float path, snapshot / restore, ``redeploy``); ``VisionEngine``
(repair on retry, cohort degradation, the cohort levers).

The engines' fault draws are the reference's (``JaxDrawer``), so the
port's ``health`` counts, greedy tokens and top-1 equal the JAX engines'
under the same injector. At ``<W:I>`` the LM is compared at one layer
(``ROADMAP.md``: the PIM LM path is chaotic across packages).
"""
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import JaxDrawer
from repro.training import fault_tolerance as jft
from repro_torch.pim import faults as TF
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import fault_tolerance as tft


# -- the step loop's parts ------------------------------------------------------

def test_straggler_detector_flags_the_reference_sequence():
    rng = np.random.default_rng(0)
    for trial in range(3):
        det, ref = tft.StragglerDetector(4.0), jft.StragglerDetector(4.0)
        for i in range(400):
            dt = float(rng.choice([0.1, 0.1, 0.1, 0.1001, 0.2,
                                   rng.lognormal(-2.0, 1.5)]))
            assert det.observe(dt) == ref.observe(dt), (trial, i, dt)
        assert det.flagged == ref.flagged > 0


def test_restart_policy_budget_matches_reference():
    pol, ref = tft.RestartPolicy(2, 0.01), jft.RestartPolicy(2, 0.01)
    for _ in range(2):
        assert pol.on_failure() == ref.on_failure()
    for p in (pol, ref):
        with pytest.raises(RuntimeError, match="exceeded 2 failures"):
            p.on_failure()
    pol.record_progress(60)
    assert pol.failures == 0 and pol.on_failure() == 0.01
    assert tft.WatchdogConfig() == tft.WatchdogConfig(**vars(
        jft.WatchdogConfig()))
    assert dict(vars(tft.FTConfig()), ckpt_dir=None) == \
        dict(vars(jft.FTConfig()), ckpt_dir=None)


class _Data:
    """A data source keyed by step, as the reference's synthetic one."""

    def batch(self, step):
        return {"x": np.full((4,), step % 7, np.float32)}


def _toy_run(pkg, ckdir, n_steps, inject):
    """The same toy step in both packages: w <- w * 0.5 + mean(x), the
    optimizer state counting steps."""
    if pkg == "port":
        import torch as lib

        def step(p, o, b):
            w = p["w"] * 0.5 + lib.as_tensor(b["x"]).mean()
            return {"w": w}, {"n": o["n"] + 1}, {"loss": w.sum()}

        params, opt = {"w": torch.zeros(3)}, {"n": torch.zeros((), dtype=
                                                               torch.int32)}
        run, pending = tft.run_resilient, tckpt.wait_pending
        cfg = tft.FTConfig(ckpt_dir=ckdir, ckpt_every=4, max_failures=5)
    else:
        import jax.numpy as jnp

        def step(p, o, b):
            w = p["w"] * 0.5 + jnp.asarray(b["x"]).mean()
            return {"w": w}, {"n": o["n"] + 1}, {"loss": w.sum()}

        from repro.training import checkpoint as jckpt

        params, opt = {"w": jnp.zeros(3)}, {"n": jnp.zeros((), jnp.int32)}
        run, pending = jft.run_resilient, jckpt.wait_pending
        cfg = jft.FTConfig(ckpt_dir=ckdir, ckpt_every=4, max_failures=5)
    left = dict(inject)

    def injector(s):
        # Each step waits for the last async save: the reference's saves
        # share one pointer temp file, so overlapping ones race.
        pending()
        if left.get(s, 0) > 0:
            left[s] -= 1
            raise RuntimeError("injected node failure")

    return run(step, params, opt, _Data(), n_steps, cfg,
               fail_injector=injector)


def test_run_resilient_recovers_and_restarts_like_the_reference(tmp_path):
    """Two failures at step 10 roll back to the step-8 checkpoint; the
    stats, the final checkpoint and the parameters equal the reference's
    and an uninterrupted run's."""
    got = _toy_run("port", str(tmp_path / "p"), 14, {10: 2})
    want = _toy_run("jax", str(tmp_path / "j"), 14, {10: 2})
    clean = _toy_run("port", str(tmp_path / "c"), 14, {})
    assert got[2] == want[2] and got[2]["restarts"] == 2
    assert got[2]["steps_run"] == want[2]["steps_run"] == 16
    assert tckpt.latest_step(str(tmp_path / "p")) == 13
    np.testing.assert_array_equal(got[0]["w"].numpy(), np.asarray(
        want[0]["w"]))
    assert torch.equal(got[0]["w"], clean[0]["w"])
    assert int(got[1]["n"]) == int(want[1]["n"]) == 14
    # A restarted loop resumes from LATEST: nothing left to run.
    again = _toy_run("port", str(tmp_path / "p"), 14, {})
    assert again[2]["steps_run"] == 0 and torch.equal(again[0]["w"],
                                                      got[0]["w"])


# -- ServeEngine ----------------------------------------------------------------

# Every projection (and the head) 32 x 32: the JAX package's eager
# prepack and injection compile each op once a shape.
_LM = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=32,
           vocab=32, dtype="float32")
_FAULTS = dict(write_ber=5e-3, read_disturb_ber=2e-2, protect_msb=1, seed=1)
_PROMPTS = ([3, 1], [7, 8], [9, 2], [5, 5], [1, 4])


@pytest.fixture(scope="module")
def lm():
    """One layer at <2:2> int-direct, d_model 32: JAX init from PRNGKey(0)
    and the same tree carried to the port."""
    from repro.core import PIMQuantConfig as JP
    from repro.models.lm import ModelConfig as JMC
    from repro.models.lm import model as JM
    from repro_torch import convert
    from repro_torch.core import PIMQuantConfig as TP
    from repro_torch.models.lm import ModelConfig as TMC

    jc = JMC(remat="none", pim=JP(2, 2, backend="int-direct"), **_LM)
    tc = TMC(pim=TP(2, 2, backend="int-direct"), **_LM)
    jp = jax.device_get(jax.jit(JM.init, static_argnums=0)(
        jc, jax.random.PRNGKey(0)))
    return dict(jc=jc, tc=tc, jp=jp, tp=convert.params_from_jax(jp))


def _injector(plan):
    """Raises at dispatch d as many times as ``plan[d]`` says."""
    left = dict(plan)

    def inj(d):
        if left.get(d, 0) > 0:
            left[d] -= 1
            raise RuntimeError("injected mid-decode fault")
    return inj


def _serve(pkg, lm, snap_dir=None, plan=None, faults=True, **kw):
    """Five 2-token prompts on 4 slots, 7 greedy tokens each, one decode
    step a dispatch; with ``snap_dir`` a snapshot after two steps.
    Returns (engine, {rid: tokens})."""
    if pkg == "port":
        from repro_torch.serving import Request, SamplerConfig, ServeEngine

        cfg, params = lm["tc"], lm["tp"]
        fc = TF.FaultConfig(**_FAULTS) if faults else None
        wd = tft.WatchdogConfig(max_failures=2, backoff_s=0.0)
        kw.setdefault("device", "cpu")
    else:
        from repro.pim.faults import FaultConfig
        from repro.serving import Request, SamplerConfig, ServeEngine

        cfg, params = lm["jc"], lm["jp"]
        fc = FaultConfig(**_FAULTS) if faults else None
        wd = jft.WatchdogConfig(max_failures=2, backoff_s=0.0)
    if plan is not None:
        kw.update(watchdog=wd, fault_injector=_injector(plan))
    eng = ServeEngine(cfg, params, max_batch=4, max_len=32,
                      sampler=SamplerConfig(temperature=0.0), drain_steps=1,
                      faults=fc, **kw)
    for rid, p in enumerate(_PROMPTS):
        eng.submit(Request(rid=rid, prompt=np.array(p, np.int32),
                           max_new_tokens=7))
    out = []
    if snap_dir is not None:
        out = eng.step() + eng.step()
        eng.snapshot(snap_dir, step=2)
    out += eng.run()
    return eng, {c.rid: c.tokens for c in out}


@pytest.fixture(scope="module")
def reference_run(lm, tmp_path_factory):
    """The JAX engine under persistent and transient faults, a watchdog
    with a budget of 2 and an injector that raises once at dispatch 1 and
    twice at dispatch 3 (so the third failure degrades it to the float
    path), with a snapshot after two steps."""
    d = str(tmp_path_factory.mktemp("jsnap"))
    eng, toks = _serve("jax", lm, snap_dir=d, plan={1: 1, 3: 2})
    with open(f"{d}/step_00000002/manifest.json") as f:
        extra = json.load(f)["extra"]
    return dict(health=dict(eng.health), tokens=toks, extra=extra,
                pim=eng.cfg.pim.enabled)


def test_serve_engine_rollback_and_degrade_match_reference(
        lm, reference_run, tmp_path):
    """Rollback and retry replay the same transient draws (the key chain
    rides in the shadow), the spent budget degrades to the float path,
    and the ``health`` counts, tokens and the snapshot's manifest
    ``extra`` equal the JAX engine's."""
    with TF.use_drawer(JaxDrawer()):
        eng, toks = _serve("port", lm, snap_dir=str(tmp_path), plan={1: 1,
                                                                     3: 2})
    assert eng.health == reference_run["health"]
    assert eng.health["rollbacks"] == 3 and eng.health["degraded"]
    assert not eng.cfg.pim.enabled and not reference_run["pim"]
    assert eng.faults is None
    assert toks == reference_run["tokens"]
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["extra"] == reference_run["extra"]


def test_serve_engine_retry_gives_the_uninjected_tokens(lm):
    """One injected failure with transient faults on: the retried
    dispatch draws what the first attempt drew, so the tokens equal the
    same engine's without an injector; one dispatch rolled back."""
    _, want = _serve("port", lm)
    eng, got = _serve("port", lm, plan={2: 1})
    assert got == want
    h = eng.health
    assert (h["rollbacks"], h["degraded"]) == (1, False)
    assert h["dispatches"] == 12     # 4 slots, then the queued fifth alone


def test_serve_engine_non_finite_logits_roll_back(lm, monkeypatch):
    """The logits health read in the dispatch's one copy: a step whose
    logits are not finite fails the dispatch, which is retried."""
    from repro_torch.serving import engine as E

    real, calls = E.decode_step, {"n": 0}

    def poisoned(*a, **k):
        logits, *rest = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            logits = logits * float("nan")
        return (logits, *rest)

    _, want = _serve("port", lm)
    monkeypatch.setattr(E, "decode_step", poisoned)
    eng, got = _serve("port", lm, plan={})
    assert eng.health["rollbacks"] == 1 and got == want


def test_snapshot_restore_with_another_seed_at_temperature(lm, tmp_path):
    """A snapshot mid-generation restored into an engine with another seed
    continues with the same tokens at temperature 0.7: the sampling
    generator's state and the key chain ride in the saved tree, and
    transient faults draw the same."""
    from repro_torch.serving import Request, SamplerConfig, ServeEngine

    def fresh(seed):
        return ServeEngine(lm["tc"], lm["tp"], max_batch=2, max_len=64,
                           sampler=SamplerConfig(temperature=0.7), seed=seed,
                           drain_steps=2, device="cpu",
                           faults=TF.FaultConfig(**_FAULTS))

    eng = fresh(0)
    for rid, p in enumerate(([3, 1, 4], [1, 5, 9, 2], [2, 7])):
        eng.submit(Request(rid=rid, prompt=np.array(p, np.int32),
                           max_new_tokens=12))
    assert not eng.step()
    eng.snapshot(str(tmp_path), step=1)
    want = {c.rid: c.tokens for c in eng.run()}
    eng2 = fresh(99)
    manifest = eng2.restore(str(tmp_path))
    assert [s["rid"] for s in manifest["extra"]["queue"]] == [2]
    got = {c.rid: c.tokens for c in eng2.run()}
    assert got == want


def test_redeploy_needs_the_masters_and_keeps_serving(lm):
    """``redeploy`` re-prepacks from the masters kept by
    ``keep_masters``; without them it raises, as the reference's does.
    In-flight requests continue on the new path."""
    from repro_torch.core import PIMQuantConfig
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(lm["tc"], lm["tp"], max_batch=2, max_len=32,
                      device="cpu")
    assert eng._raw_params is None
    with pytest.raises(RuntimeError, match="keep_masters"):
        eng.redeploy(PIMQuantConfig(8, 8, backend="int-direct"))
    eng = ServeEngine(lm["tc"], lm["tp"], max_batch=2, max_len=32,
                      device="cpu", keep_masters=True)
    eng.submit(Request(rid=0, prompt=np.array([3, 1], np.int32),
                       max_new_tokens=6))
    eng.step()
    eng.redeploy(PIMQuantConfig(8, 8, backend="popcount"))
    assert eng.cfg.pim.w_bits == 8
    assert eng.params["scan"][0]["attn"]["wq"][0].bits == 8
    done = eng.run()
    assert len(done) == 1 and len(done[0].tokens) == 6
    eng.close()
    assert eng._raw_params is None


# -- VisionEngine ---------------------------------------------------------------

_IMAGE = 16
_VFAULTS = dict(write_ber=2e-2, read_disturb_ber=2e-2, checksum=True,
                spare_cols=2, subarray_cols=8, seed=3)


class _Tiny:
    """A small CNN on a package's layer blocks (the ``(module, params)``
    path both engines take): a 3x3 conv, a 2x2 max pool, a strided 3x3
    conv with a bias, the global average pool and an FC head."""

    def __init__(self, layers):
        self.L = layers

    def apply(self, params, x, cfg=None):
        L = self.L
        x = L.conv_block(params["c1"], x, 1, 1, cfg=cfg)
        x = L.max_pool(x, 2, 2)
        x = L.conv_block(params["c2"], x, 2, 1, cfg=cfg)
        return L.fc_block(params["fc"], L.avg_pool_global(x), cfg=cfg,
                          relu=False)


@pytest.fixture(scope="module")
def tiny():
    """The tiny CNN's weights from numpy seed 0 in both packages (BN
    statistics drawn so they count), and three 16 px images."""
    from repro.models.cnn import layers as jl
    from repro_torch import convert
    from repro_torch.models.cnn import layers as tl

    rng = np.random.default_rng(0)

    def nrm(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {
        "c1": {"w": nrm(3, 3, 3, 8, scale=0.3), "gamma": 1 + nrm(8,
               scale=0.1), "beta": nrm(8, scale=0.1), "mean": nrm(8,
               scale=0.1), "var": 1 + np.abs(nrm(8, scale=0.1))},
        "c2": {"w": nrm(3, 3, 8, 8, scale=0.2), "b": nrm(8, scale=0.1)},
        "fc": {"w": nrm(8, 10, scale=0.3), "b": nrm(10, scale=0.1)},
    }
    imgs = [nrm(_IMAGE, _IMAGE, 3) for _ in range(3)]
    return dict(jmod=_Tiny(jl), tmod=_Tiny(tl), jp=params,
                tp=convert.params_from_jax(params), imgs=imgs)


def _vision(pkg, net, plan, **kw):
    """Three <4:4> requests in buckets of 1 through an engine with
    persistent and transient faults (engine seed 5), a watchdog (budget 2)
    and an injector. Returns (engine, {rid: (top1, logits)})."""
    if pkg == "port":
        from repro_torch.serving import VisionEngine, VisionRequest

        model, fc = (net["tmod"], net["tp"]), TF.FaultConfig(**_VFAULTS)
        wd = tft.WatchdogConfig(max_failures=2, backoff_s=0.0)
        kw.setdefault("device", "cpu")
    else:
        from repro.pim.faults import FaultConfig
        from repro.serving.vision import VisionEngine, VisionRequest

        model, fc = (net["jmod"], net["jp"]), FaultConfig(**_VFAULTS)
        wd = jft.WatchdogConfig(max_failures=2, backoff_s=0.0)
    eng = VisionEngine({"tiny": model}, backend="int-direct", max_batch=1,
                       faults=fc, watchdog=wd, fault_injector=plan, seed=5,
                       **kw)
    for i, im in enumerate(net["imgs"]):
        eng.submit(VisionRequest(rid=i, image=im, model="tiny",
                                 precision="<4:4>"))
    return eng, {c.rid: (c.top1, c.logits) for c in eng.run(strict=True)}


def _vision_plan():
    """Raises at dispatch 1 once (repair on retry), then at every call
    from dispatch 2 on (the third failure degrades the cohort)."""
    state = {"armed": True}

    def inj(d):
        if d == 1 and state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected vision fault")
        if d >= 2:
            raise RuntimeError("sustained vision fault")
    return inj


def test_vision_repair_on_retry_and_cohort_degradation_match_reference(
        tiny):
    """The failed bucket's retry repairs flagged columns from the golden
    tree; later sustained failures degrade the cohort to the float path.
    Every quantized attempt reads under its own disturb key (a split of
    the engine's fault key), the float one draws nothing: ``health`` and
    the top-1 equal the JAX engine's, the quantized buckets' logits agree
    within 1e-4 of max|logit| (the JAX engine's forward is jitted), and
    the degraded bucket is the float forward."""
    from repro_torch.serving import VisionEngine, VisionRequest

    jeng, want = _vision("jax", tiny, _vision_plan())
    drawer = JaxDrawer()
    with TF.use_drawer(drawer):
        eng, got = _vision("port", tiny, _vision_plan())
    # The deploy's 3 leaves x 4 planes, then 2 quantized forwards
    # (dispatch 0 and the retry of dispatch 1; the injector stops the
    # other attempts before theirs) x 3 sites x 4 planes.
    assert drawer.draws == 3 * 4 + 2 * 3 * 4 and eng._fault_chain == 2
    assert eng.health == jeng.health
    h = eng.health
    assert h["degraded"] == [("tiny", "<4:4>")]
    assert (h["dispatches"], h["rollbacks"], h["repairs"]) == (2, 3, 2)
    assert h["repaired_cols"] > 0
    assert {r: v[0] for r, v in got.items()} == \
        {r: v[0] for r, v in want.items()}
    for r in range(3):
        scale = float(np.abs(want[r][1]).max())
        np.testing.assert_allclose(got[r][1], want[r][1], rtol=1e-4,
                                   atol=1e-4 * scale)
    flt = VisionEngine({"tiny": (tiny["tmod"], tiny["tp"])},
                       backend="int-direct", max_batch=1, device="cpu")
    flt.submit(VisionRequest(rid=2, image=tiny["imgs"][2], model="tiny",
                             precision=None))
    assert np.array_equal(flt.run()[0].logits, got[2][1])


def test_vision_cohort_levers(tiny):
    """``degrade_cohort`` / ``restore_cohort`` move a cohort by hand, as
    the reference's do; a degraded cohort serves the float forward."""
    from repro_torch.serving import VisionEngine, VisionRequest

    eng = VisionEngine({"tiny": (tiny["tmod"], tiny["tp"])},
                       backend="int-direct", max_batch=1, device="cpu")
    assert not eng.degrade_cohort("tiny", None)
    assert eng.degrade_cohort("tiny", "<8:8>")
    assert not eng.degrade_cohort("tiny", "<8:8>")
    eng.submit(VisionRequest(rid=0, image=tiny["imgs"][0], model="tiny",
                             precision="<8:8>"))
    deg = eng.run()[0]
    assert eng.prepacks == 1 and ("tiny", "<8:8>") not in eng._packed
    assert eng.restore_cohort("tiny", "<8:8>")
    assert not eng.restore_cohort("tiny", "<8:8>")
    eng.submit(VisionRequest(rid=1, image=tiny["imgs"][0], model="tiny",
                             precision="<8:8>"))
    back = eng.run()[0]
    assert eng.health["degraded"] == [("tiny", "<8:8>")]
    assert not np.array_equal(deg.logits, back.logits)
