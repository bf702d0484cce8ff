"""The port's ``ServeEngine`` on the dense archs against the JAX engine on
the CPU, at their ``reduced()`` width in float32: greedy tokens equal to
the JAX engine's for several requests on fewer slots, with prompt lengths
whose power-of-two chunks mix 16 or more tokens with 8/4/2/1 (so chunks
prefill at offsets above 0 against the cached rows), on the float path,
the int8 KV cache and the <8:8> PIM path; slot reuse, dead slots,
``stats()`` and ``close()``, the launcher and the example twin.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSamplerConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.core import PIMQuantConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models.lm import model as M
from repro_torch.serving import Request, SamplerConfig, ServeEngine

from _torch_parity import dense_models, t


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# Prompt lengths and their chunks: 37 = 32+4+1, 50 = 32+16+2, 21 = 16+4+1,
# 24 = 16+8, 11 = 8+2+1, 3 = 2+1.
PROMPT_LENS = (37, 50, 21, 24, 11, 3)
N_NEW = 6
MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    """qwen3-0.6b and llama3.2-3b, reduced, float32, one set of weights in
    both packages, and six prompts."""
    out = dense_models(("qwen3-0.6b", "llama3.2-3b"), seed=1)
    out["prompts"] = [np.random.default_rng(20 + i).integers(
        0, 512, size=n).astype(np.int32) for i, n in enumerate(PROMPT_LENS)]
    return out


def _serve_jax(cfg, params, prompts, max_batch=2):
    eng = JServeEngine(cfg, params, max_batch=max_batch, max_len=MAX_LEN,
                       sampler=JSamplerConfig(temperature=0.0))
    for rid, p in enumerate(prompts):
        eng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=N_NEW))
    return {c.rid: c.tokens for c in eng.run()}


def _engine(cfg, params, max_batch=2, **kw):
    return ServeEngine(cfg, params, max_batch=max_batch, max_len=MAX_LEN,
                       sampler=SamplerConfig(temperature=0.0), device="cpu",
                       **kw)


def _serve(cfg, params, prompts, max_batch=2, **kw):
    eng = _engine(cfg, params, max_batch, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=N_NEW))
    return {c.rid: c.tokens for c in eng.run(strict=True)}


def _layers(d, n):
    """The first ``n`` layers of an arch's configs and weights."""
    jc, tc = (dataclasses.replace(c, n_layers=n) for c in (d["jc"], d["tc"]))
    jp = dict(d["jp"], scan=[jax.tree.map(lambda x: x[:n],
                                          d["jp"]["scan"][0])])
    return jc, tc, jp, convert.params_from_jax(jp)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3.2-3b"])
def test_engine_greedy_tokens_equal_jax_engine(models, arch):
    """Six requests on two slots, float32: every greedy token equal to the
    (jitted) JAX engine's."""
    d = models[arch]
    want = _serve_jax(d["jc"], d["jp"], models["prompts"])
    assert _serve(d["tc"], d["tp"], models["prompts"]) == want


def test_engine_int8_kv_greedy_tokens_equal_jax_engine(models):
    """The int8 KV cache (``kv_quant``), six requests on two slots, at one
    layer: the greedy tokens equal the JAX engine's. Deeper, an ulp of
    float jitter in k flips a code at a rounding boundary and later layers
    carry it on (see test_torch_dense.py::test_kv_quant_decode_matches_jax),
    so tokens may part at near-ties, as on the <8:8> path."""
    jc, tc, jp, tp = _layers(models["llama3.2-3b"], 1)
    jc, tc = (dataclasses.replace(c, kv_quant=True) for c in (jc, tc))
    want = _serve_jax(jc, jp, models["prompts"])
    assert _serve(tc, tp, models["prompts"]) == want


@pytest.mark.parametrize("backend", ["int-direct", "cuda"])
def test_engine_pim_greedy_tokens_equal_jax_engine(models, backend):
    """<8:8>, every projection prepacked once and the tied head quantized
    per call, six requests on two slots, at one layer (the PIM LM path is
    chaotic deeper; ``ROADMAP.md`` Queue 3): the port's ``int-direct`` and
    ``cuda`` (kernels 1-2's plain versions here) give the JAX engine's
    int-direct tokens."""
    jc, tc, jp, tp = _layers(models["qwen3-0.6b"], 1)
    jc = dataclasses.replace(jc, pim=JPIMQuantConfig(8, 8,
                                                     backend="int-direct"))
    tc = dataclasses.replace(tc, pim=PIMQuantConfig(8, 8, backend=backend))
    want = _serve_jax(jc, jp, models["prompts"])
    assert _serve(tc, tp, models["prompts"]) == want


def test_engine_matches_naive_greedy(models):
    """Chunked prefill (16 + 4 + 1) against the KV cache gives the tokens
    of repeated full forwards."""
    d = models["qwen3-0.6b"]
    prompt = models["prompts"][2]
    toks = prompt.tolist()
    for _ in range(N_NEW):
        logits, _ = M.forward(d["tp"], d["tc"], torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    assert _serve(d["tc"], d["tp"], [prompt]) == {0: toks[len(prompt):]}


def test_slot_reuse_no_kv_leak(models):
    """Prefilling B into a slot A used gives the logits of a fresh grid,
    bit for bit, and zeroes A's rows past B's."""
    d = models["llama3.2-3b"]
    a = t(models["prompts"][1][None])               # 50 tokens
    b = t(models["prompts"][2][None])               # 21 tokens
    dirty = M.init_state(d["tc"], 2, MAX_LEN, device="cpu")
    _, dirty = M.prefill_into_slot(d["tp"], d["tc"], a, dirty, 0, 0)
    got, dirty = M.prefill_into_slot(d["tp"], d["tc"], b, dirty, 0, 0)
    want, _ = M.prefill_into_slot(
        d["tp"], d["tc"], b, M.init_state(d["tc"], 2, MAX_LEN, device="cpu"),
        0, 0)
    assert torch.equal(got, want)
    assert not dirty["scan"][0]["k"][:, 0, 21:].any()


def test_dead_slots_do_not_advance(models):
    """A slot whose request ended keeps its length while the other slot
    decodes on; its writes land on that one row."""
    d = models["qwen3-0.6b"]
    eng = _engine(d["tc"], d["tp"])
    eng.submit(Request(rid=0, prompt=models["prompts"][5], max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=models["prompts"][4],
                       max_new_tokens=12))
    done = eng.run(strict=True)
    assert sorted(len(c.tokens) for c in done) == [2, 12]
    # 3 + 2 - 1 = 4 rows written by request 0, 11 + 12 - 1 = 22 by 1.
    assert eng.state["length"].tolist() == [4, 22]


def test_cancel_slot_reuse(models):
    """The request that inherits a cancelled slot matches a fresh engine's
    run exactly."""
    d = models["qwen3-0.6b"]
    p_a, p_b = models["prompts"][0], models["prompts"][3]
    want = _serve(d["tc"], d["tp"], [p_b], max_batch=1)[0]
    eng = _engine(d["tc"], d["tp"], max_batch=1, drain_steps=1)
    eng.submit(Request(rid=1, prompt=p_a, max_new_tokens=12))
    eng.step()
    assert eng.cancel(1) == "active"
    eng.submit(Request(rid=2, prompt=p_b, max_new_tokens=N_NEW))
    done = eng.run()
    assert [c.rid for c in done] == [2] and done[0].tokens == want


def test_stats_and_close_have_the_jax_engines_keys(models):
    """``stats()`` has the JAX engine's keys (a dense model has no ring
    channels); dispatches are counted; ``close()`` drops the device
    tensors and refuses further work."""
    d = models["qwen3-0.6b"]
    jeng = JServeEngine(d["jc"], d["jp"], max_batch=2, max_len=MAX_LEN)
    want = jeng.stats()
    jeng.close()
    eng = _engine(d["tc"], d["tp"])
    assert eng.stats() == {"health": {"dispatches": 0, "rollbacks": 0,
                                      "stragglers": 0, "snapshots": 0,
                                      "degraded": False}}
    assert eng.stats().keys() == want.keys()
    assert eng.stats()["health"].keys() == want["health"].keys()
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=models["prompts"][rid],
                           max_new_tokens=12))
    eng.run(strict=True)
    # 11 decode steps after the first token: dispatches of 8, 2 and 1.
    assert eng.stats()["health"]["dispatches"] == 3
    eng.close()
    assert eng.params is None and eng.state is None
    assert eng.stats()["health"]["dispatches"] == 3
    with pytest.raises(RuntimeError, match="close"):
        eng.submit(Request(rid=9, prompt=models["prompts"][0]))


def test_bf16_engine_keeps_a_bf16_cache(models):
    """The KV cache takes the model's dtype, and a bf16 engine serves."""
    d = models["llama3.2-3b"]
    tc = dataclasses.replace(d["tc"], dtype="bfloat16")
    eng = _engine(tc, M.cast_params(d["tp"], torch.bfloat16))
    assert eng.state["scan"][0]["k"].dtype == torch.bfloat16
    eng.submit(Request(rid=0, prompt=models["prompts"][2], max_new_tokens=4))
    (c,) = eng.run(strict=True)
    assert len(c.tokens) == 4 and all(0 <= x < tc.vocab for x in c.tokens)


def test_cpu_engine_launches_no_kernel(models):
    """On CPU tensors every kernel wrapper runs its plain version."""
    jc, tc, jp, tp = _layers(models["llama3.2-3b"], 1)
    tc = dataclasses.replace(tc, pim=PIMQuantConfig(8, 8, backend="cuda"))
    ops.reset_launch_counts()
    _serve(tc, tp, models["prompts"][2:3])
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3.2-3b",
                                  "qwen1.5-4b", "granite-3-2b"])
def test_launcher_serves_dense_arch_on_cpu(capsys, arch):
    tserve.main(["--workload", "lm", "--arch", arch, "--reduced",
                 "--requests", "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out[:2]] == ["req 0", "req 1"]
    assert out[2].startswith("2 completions, 6 tokens in")


def test_launcher_serves_pim_dense_on_cpu(capsys):
    tserve.main(["--workload", "lm", "--arch", "llama3.2-3b", "--reduced",
                 "--requests", "2", "--max-new", "3", "--device", "cpu",
                 "--precision", "<8:8>", "--backend", "cuda"])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "2 completions, 6 tokens in")


def test_torch_serve_lm_example_runs_on_cpu(capsys):
    """examples/torch_serve_lm.py, the twin of examples/serve_lm.py:
    ten requests on four slots all complete."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_serve_lm.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "10/10 requests complete" in out
