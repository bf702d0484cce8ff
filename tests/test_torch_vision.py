"""Port parity, the slice as a whole: ResNet through ``VisionEngine`` in
``repro_torch`` against the JAX package's engine, plus the engine's own
contract (buckets, prepack once, CUDA by default), the launcher, the
import hygiene of the port and ``chip_smoke.py``'s refusals off the card.

ResNet-50 at full depth under JAX eager takes minutes here, so the
whole-slice comparison cuts the depth (``_STAGES`` patched in both
packages, a module attribute read at call time) and keeps the widths'
structure; full depth and width run on the card in ``chip_smoke.py``."""
import ast
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.core.quantize import calibrate_minmax as jcalibrate
from repro.core.quantize import quantize as jquantize
from repro.models.cnn import layers as jL
from repro.models.cnn import resnet as jresnet
from repro.serving import VisionEngine as JVisionEngine
from repro.serving import VisionRequest as JVisionRequest
from repro.serving import parse_precision as jparse_precision
from repro_torch import convert
from repro_torch.core.quantize import calibrate_minmax as tcalibrate
from repro_torch.core.quantize import quantize as tquantize
from repro_torch.launch import serve as tserve
from repro_torch.models.cnn import layers as tL
from repro_torch.models.cnn import resnet as tresnet
from repro_torch.serving import VisionEngine, VisionRequest, parse_precision

_REPO = Path(__file__).resolve().parent.parent
_SMALL_STAGES = [(1, 64), (1, 128)]


def _images(n, image, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, image, image, 3)).astype(np.float32)


def _serve(eng, req_cls, imgs):
    for rid in range(len(imgs)):
        eng.submit(req_cls(rid=rid, image=imgs[rid], model="resnet50",
                           precision="<8:8>"))
    return sorted(eng.run(strict=True), key=lambda c: c.rid)


@pytest.fixture(scope="module")
def slice_run():
    """The JAX engine (int-direct: its P is bit-identical to "pallas") and
    the port's engine (backend "cuda" on the CPU) on the same converted
    weights: 3 images at 32 px, 10 classes, <8:8>, max_batch 4 -> buckets
    2 + 1. The JAX engine serves twice: jitted, as it deploys, and op by op
    under ``jax.disable_jit`` (its engine machinery, the reference's
    unfused arithmetic)."""
    imgs = _images(3, 32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresnet, "_STAGES", _SMALL_STAGES)
        mp.setattr(tresnet, "_STAGES", _SMALL_STAGES)
        jparams = jresnet.init(jax.random.PRNGKey(0), num_classes=10,
                               image=32)
        tparams = convert.params_from_jax(jax.device_get(jparams))
        jeng = JVisionEngine({"resnet50": jparams}, backend="int-direct",
                             max_batch=4)
        out = {"jax_jit": _serve(jeng, JVisionRequest, imgs)}
        with jax.disable_jit():
            out["jax"] = _serve(jeng, JVisionRequest, imgs)
        jeng.close()
        teng = VisionEngine({"resnet50": tparams}, backend="cuda",
                            max_batch=4, device="cpu")
        out["torch"] = _serve(teng, VisionRequest, imgs)
        # Per-layer inputs of the first bucket, for naming a code flip.
        jcfg = JPIMQuantConfig(8, 8, backend="int-direct")
        jpk = jresnet.prepack(jparams, jcfg)
        tpk = tresnet.prepack(tparams, teng._cfg("<8:8>"))
        out["jax_jit_layers"] = jax.jit(lambda p, x: _layer_inputs(
            jL, lambda: jresnet.apply(p, x, cfg=jcfg)))(
                jpk, jax.numpy.asarray(imgs[:2]))
        with torch.inference_mode():
            out["torch_layers"] = _layer_inputs(tL, lambda: tresnet.apply(
                tpk, torch.from_numpy(imgs[:2]), cfg=teng._cfg("<8:8>")))
    return out


def _layer_inputs(layers_mod, run):
    """(logits, [input of every pim_conv2d / pim_linear call, in order])."""
    acts = []
    conv, lin = layers_mod.pim_conv2d, layers_mod.pim_linear

    def spy(fn):
        def wrapped(x, *a, **k):
            acts.append(x)
            return fn(x, *a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers_mod, "pim_conv2d", spy(conv))
        mp.setattr(layers_mod, "pim_linear", spy(lin))
        return run(), acts


_LAYERS = ["stem", "s0b0.c1", "s0b0.c2", "s0b0.c3", "s0b0.proj", "s1b0.c1",
           "s1b0.c2", "s1b0.c3", "s1b0.proj", "head"]


def _logits(done):
    return np.stack([c.logits for c in done])


def test_slice_buckets_and_top1_match_jax(slice_run):
    for ref in ("jax", "jax_jit"):
        assert [c.batch for c in slice_run["torch"]] == \
            [c.batch for c in slice_run[ref]] == [2, 2, 1]
        assert [c.top1 for c in slice_run["torch"]] == \
            [c.top1 for c in slice_run[ref]]


def test_slice_logits_match_jax(slice_run):
    got, want = _logits(slice_run["torch"]), _logits(slice_run["jax"])
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_slice_against_jitted_jax_engine_names_first_code_flip(slice_run):
    """Against the jitted JAX engine, the logits agree to rtol 1e-4 unless
    XLA's fusion of the float epilogues moves an activation across a
    rounding boundary. Then this names the first layer whose input codes
    differ, and holds the port to the rest: every earlier layer's codes are
    equal, the float inputs there agree to 1e-4*max, and no code moves by
    more than one step."""
    got, want = _logits(slice_run["torch"]), _logits(slice_run["jax_jit"])
    if np.allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max()):
        return
    (jlogits, jacts), (tlogits, tacts) = (slice_run["jax_jit_layers"],
                                          slice_run["torch_layers"])
    assert np.array_equal(np.asarray(jlogits), want[:2])
    assert np.array_equal(tlogits.numpy(), got[:2])
    assert len(jacts) == len(tacts) == len(_LAYERS)
    for name, ja, ta in zip(_LAYERS, jacts, tacts):
        ja, ta = np.asarray(ja), ta.numpy()
        jcodes = jquantize(ja, jcalibrate(ja, 8))
        tcodes = tquantize(torch.from_numpy(ta),
                           tcalibrate(torch.from_numpy(ta), 8)).numpy()
        if not np.array_equal(np.asarray(jcodes), tcodes):
            break
    else:
        raise AssertionError("logits differ but every layer's codes agree")
    flips = np.abs(np.asarray(jcodes).astype(np.int64) - tcodes)
    warnings.warn(f"first code flip at {name}: {int((flips > 0).sum())} of "
                  f"{flips.size} codes, float inputs differ by at most "
                  f"{float(np.abs(ja - ta).max()):.3g}")
    np.testing.assert_allclose(ta, ja, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ja).max()),
                               err_msg=f"first code flip at {name}")
    assert flips.max() == 1, f"first code flip at {name}: {flips.max()}"


@pytest.mark.parametrize("precision", [None, "float", "fp32", "<8:8>",
                                       "<2:4>", "<8:8", "8:8", "<a:b>"])
def test_parse_precision_matches_jax(precision):
    try:
        want = jparse_precision(precision)
    except ValueError:
        with pytest.raises(ValueError):
            parse_precision(precision)
        return
    assert parse_precision(precision) == want


@pytest.fixture
def small_resnet(monkeypatch):
    monkeypatch.setattr(tresnet, "_STAGES", [(1, 16), (1, 32)])
    return tresnet.init(torch.Generator().manual_seed(0), num_classes=7,
                        image=16)


def test_engine_buckets_prepack_once_and_matches_apply(small_resnet):
    """5 queued -> buckets 4 + 1; one prepack per (model, precision), reused
    by the next run; logits equal ``apply`` on the same stacked batch."""
    imgs = _images(5, 16, seed=1)
    eng = VisionEngine({"resnet50": small_resnet}, max_batch=4, device="cpu")
    for _ in range(2):
        for rid in range(5):
            eng.submit(VisionRequest(rid=rid, image=imgs[rid]))
        done = sorted(eng.run(strict=True), key=lambda c: c.rid)
    assert [c.batch for c in done] == [4, 4, 4, 4, 1]
    assert eng.prepacks == 1
    packed = tresnet.prepack(small_resnet, eng._cfg("<8:8>"))
    with torch.inference_mode():
        ref = tresnet.apply(packed, torch.from_numpy(imgs[:4]),
                            cfg=eng._cfg("<8:8>")).numpy()
    for i in range(4):
        assert np.array_equal(done[i].logits, ref[i])
        assert done[i].top1 == int(ref[i].argmax())


def test_engine_float_path_and_mixed_cohorts(small_resnet):
    """Float spellings share one cohort served by the float forward; a
    quantized cohort is bucketed apart from it."""
    imgs = _images(4, 16, seed=2)
    eng = VisionEngine({"resnet50": small_resnet}, max_batch=4, device="cpu")
    for rid, prec in enumerate([None, "float", "<4:4>", "fp32"]):
        eng.submit(VisionRequest(rid=rid, image=imgs[rid], precision=prec))
    done = {c.rid: c for c in eng.run(strict=True)}
    assert [done[r].batch for r in range(4)] == [2, 2, 1, 1]
    with torch.inference_mode():
        ref = tresnet.apply(small_resnet, torch.from_numpy(imgs[:2])).numpy()
    assert np.array_equal(done[0].logits, ref[0])
    assert eng.prepacks == 2
    with pytest.raises(ValueError, match="precision"):
        eng.submit(VisionRequest(rid=9, image=imgs[0], precision="<8>"))
    with pytest.raises(ValueError, match="unknown model"):
        eng.submit(VisionRequest(rid=9, image=imgs[0], model="vgg19"))


def test_entry_points_default_to_cuda_and_never_run_on_cpu(small_resnet):
    """Without ``device`` the engine and the launcher ask for CUDA; with no
    GPU they raise instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        VisionEngine({"resnet50": small_resnet})
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--workload", "cnn", "--image", "16"])
    with pytest.raises(ValueError, match="backend"):
        VisionEngine({"resnet50": small_resnet}, backend="pallas",
                     device="cpu")


def test_engine_takes_the_reference_constructor_at_its_defaults():
    """The port's constructor takes the reference's keywords, in its order
    (``device`` last), and accepts a call that passes each at its default,
    as the reference does."""
    import inspect

    want = list(inspect.signature(JVisionEngine.__init__).parameters)
    got = list(inspect.signature(VisionEngine.__init__).parameters)
    assert got[-1] == "device" and got[:-1] == want
    defaults = dict(mesh=None, faults=None, watchdog=None,
                    fault_injector=None, seed=0, autotune="off",
                    tuning_cache=None)
    jeng = JVisionEngine({"resnet50": {}}, max_batch=4, **defaults)
    jeng.close()
    eng = VisionEngine({"resnet50": {}}, max_batch=4, device="cpu",
                       **dict(defaults, seed=7))
    assert eng.seed == 7 and eng.max_batch == 4


@pytest.mark.parametrize("name,value,slice_", [
    ("mesh", object(), "mesh serving")])
def test_engine_names_the_slice_of_each_later_keyword(name, value, slice_):
    with pytest.raises(NotImplementedError,
                       match=f"{name}=.*{slice_} \\(ROADMAP.md Queue 1\\)"):
        VisionEngine({"resnet50": {}}, device="cpu", **{name: value})


@pytest.mark.parametrize("name", ["faults", "watchdog", "fault_injector"])
def test_engine_takes_the_fault_keywords(name):
    """The fault model and the watchdog are ported: each keyword is taken,
    kept on the engine, and arms nothing until a dispatch."""
    from repro_torch.pim.faults import FaultConfig
    from repro_torch.training.fault_tolerance import WatchdogConfig

    value = {"faults": FaultConfig(write_ber=1e-3),
             "watchdog": WatchdogConfig(max_failures=1),
             "fault_injector": lambda d: None}[name]
    eng = VisionEngine({"resnet50": {}}, device="cpu", **{name: value})
    assert getattr(eng, name) is value
    assert eng.health == {"dispatches": 0, "rollbacks": 0, "repairs": 0,
                          "repaired_cols": 0, "degraded": []}


def test_engine_takes_autotune_and_a_tuning_cache(tmp_path):
    """The autotuner's keywords are ported: both modes and a cache path
    are taken, with no ``NotImplementedError``."""
    for mode in ("cost", "measure"):
        eng = VisionEngine({"resnet50": {}}, device="cpu", autotune=mode,
                           tuning_cache=str(tmp_path / "tune.json"))
        assert eng.autotune == mode and eng.tune_cache is None
        eng.close()


def test_engine_rejects_a_bad_autotune_like_the_reference():
    for cls in (JVisionEngine, VisionEngine):
        with pytest.raises(ValueError, match="autotune"):
            cls({"resnet50": {}}, autotune="fast")


def test_cancel_and_free_slots_match_the_reference():
    """The same queue in both engines: free slots as it fills, cancel of a
    queued, an already cancelled and an unknown rid, and the queue left."""
    image = np.zeros((16, 16, 3), np.float32)
    jeng = JVisionEngine({"resnet50": {}}, max_batch=4)
    eng = VisionEngine({"resnet50": {}}, max_batch=4, device="cpu")
    seen = []
    for e, req in ((jeng, JVisionRequest), (eng, VisionRequest)):
        free = [e.n_free_slots]
        for rid in range(5):
            e.submit(req(rid=rid, image=image))
            free.append(e.n_free_slots)
        cancels = [e.cancel(r) for r in (2, 2, 9, 0)]
        seen.append((free, cancels, [r.rid for r in e.queue],
                     e.n_free_slots))
    jeng.close()
    assert seen[0] == seen[1]
    assert seen[1] == ([4, 3, 2, 1, 0, 0], [True, False, False, True],
                       [1, 3, 4], 1)


def test_launcher_serves_on_cpu_when_asked(small_resnet, capsys):
    tserve.main(["--workload", "cnn", "--image", "16", "--classes", "7",
                 "--requests", "3", "--max-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("req 0: top1=") and "(bucket 2)" in out[0]
    assert out[2].endswith("(bucket 1)")
    assert out[-1].startswith("3 images in ")
    assert "model=resnet50@16px, precision=<8:8>, backend=cuda)" in out[-1]


def _port_sources():
    """The port's Python files, without the kernels' build directory (build
    output, which may also hold unpacked trees of other versions)."""
    build = _REPO / "src" / "repro_torch" / "kernels" / "build"
    return sorted(p for p in (_REPO / "src" / "repro_torch").rglob("*.py")
                  if build not in p.parents) + sorted(
        (_REPO / "examples").glob("torch_*.py")) + [_REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax_or_repro():
    """No import statement anywhere in the port (lazy ones included), in
    its examples (examples/torch_*.py) or in chip_smoke.py names jax,
    jaxlib or repro; the scan covers the LM stack, the serving engine,
    kernel 5's wrapper (and its backward's) and the paper's comparison
    models."""
    sources = _port_sources()
    assert len(sources) >= 48
    src = _REPO / "src" / "repro_torch"
    for rel in ("models/lm/config.py", "models/lm/norms.py",
                "models/lm/rwkv6.py", "models/lm/cache.py",
                "models/lm/model.py", "models/lm/rope.py",
                "models/lm/mlp.py", "models/lm/attention.py",
                "configs/base.py", "configs/rwkv6_3b.py",
                "configs/llama3_2_3b.py", "kernels/rwkv_chunk.py",
                "serving/sampler.py", "serving/engine.py",
                "models/lm/moe.py", "serving/gateway.py",
                "configs/phi3_5_moe_42b.py", "configs/grok_1_314b.py",
                "pim/faults.py", "training/fault_tolerance.py",
                "training/checkpoint.py", "training/optimizer.py",
                "training/data.py", "training/train_loop.py",
                "launch/train.py", "pim/area.py", "pim/baselines.py",
                "core/mapping.py"):
        assert src / rel in sources, rel
    banned = ("jax", "jaxlib", "repro")
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"


def test_importing_every_port_module_loads_no_jax_or_repro():
    code = (
        "import importlib, importlib.util, pathlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for path in sorted(pathlib.Path('examples').glob('torch_*.py')):\n"
        "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=f"{_REPO / 'src'}{os.pathsep}{_REPO}")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 45


@pytest.mark.parametrize("alone", [True, False])
def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path, alone):
    """In a directory holding only chip_smoke.py, or on a machine with no
    GPU, the smoke test exits non-zero and prints no result."""
    if not alone and torch.cuda.is_available():
        pytest.skip("a GPU is present")
    script = _REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = _REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
