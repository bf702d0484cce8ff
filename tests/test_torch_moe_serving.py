"""phi3.5-moe and grok-1 through the port's whole model and ``ServeEngine``
against the JAX package on the CPU.

Both at their ``reduced()`` width (4 layers, d_model 128, 4 experts top-2,
d_ff 256, vocab 512; grok-1 brings gelu-gated experts, attention and logit
soft-capping and the post-attention norm): forward logits within 1e-5 of
the largest and the aux loss; prefill and decode against the forward; the
engine's float32 greedy tokens equal to the (jitted) JAX engine's with
slot reuse, and its ``moe_drop_frac`` ring equal to the JAX engine's on
the same traffic (a dense engine has none); ``<8:8>`` tokens at one layer
against the JAX package run op by op (the PIM LM path is chaotic deeper,
``ROADMAP.md`` Queue 3); the launcher.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.models.lm import model as jM
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSamplerConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.core import PIMQuantConfig
from repro_torch.launch import serve as tserve
from repro_torch.models.lm import model as M
from repro_torch.serving import Request, SamplerConfig, ServeEngine

from _torch_parity import (MOE_ARCHS, assert_close, dense_cfgs, moe_cfgs,
                           moe_params, t)

# 37 = 32+4+1, 11 = 8+2+1, 70 = 64+4+2 (a 64-token chunk drops at
# capacity 40), 21 = 16+4+1, 5 = 4+1 (the fifth reuses a slot).
PROMPT_LENS = (37, 11, 70, 21, 5)
N_NEW = 5
MAX_LEN = 96


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe(request):
    """The reduced ``arch``, float32, one set of weights in both packages,
    and the prompts."""
    jc, tc = moe_cfgs(request.param)
    jp, tp = moe_params(jc, seed=1)
    prompts = [np.random.default_rng(60 + i).integers(
        0, tc.vocab, size=n).astype(np.int32) for i, n in enumerate(
            PROMPT_LENS)]
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts)


def _serve_jax(cfg, params, prompts, max_batch=2):
    eng = JServeEngine(cfg, params, max_batch=max_batch, max_len=MAX_LEN,
                       sampler=JSamplerConfig(temperature=0.0))
    for rid, p in enumerate(prompts):
        eng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=N_NEW))
    done = {c.rid: c.tokens for c in eng.run()}
    return done, eng


def _serve(cfg, params, prompts, max_batch=2):
    eng = ServeEngine(cfg, params, max_batch=max_batch, max_len=MAX_LEN,
                      sampler=SamplerConfig(temperature=0.0), device="cpu")
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=N_NEW))
    return {c.rid: c.tokens for c in eng.run(strict=True)}, eng


def test_forward_logits_and_aux_loss_match_jax(moe):
    """80 tokens (capacity 104 for 160 assignments over 4 experts) through
    the four layers: logits within 1e-5 of the largest, the aux loss
    summed over the layers within 1e-6."""
    toks = np.random.default_rng(3).integers(0, 512, (2, 40)).astype(
        np.int32)
    want, want_aux = jax.jit(lambda p, x: jM.forward(p, moe["jc"], x))(
        moe["jp"], jnp.asarray(toks))
    got, aux = M.forward(moe["tp"], moe["tc"], t(toks))
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want), rtol=1e-5)
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


def test_prefill_and_decode_match_forward(moe):
    """Chunked prefill (32 + 8 + 1) and decode steps give the forward's
    logits at each position when no assignment drops (every call's
    capacity holds its tokens: routing is per call, so a drop would part
    the paths)."""
    tc, tp = moe["tc"], moe["tp"]
    big = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=4.0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (1, 46)).astype(np.int64))
    full, _ = M.forward(tp, big, toks)
    st = M.init_state(big, 1, 64, device="cpu")
    pos = 0
    for c in (32, 8, 1):
        lo, st = M.prefill(tp, big, toks[:, pos:pos + c], st)
        pos += c
        assert_close(lo[0, 0], full[0, pos - 1].numpy(), rtol=1e-5)
    for i in range(pos, 46):
        lo, st, stats = M.decode_step(tp, big, toks[:, i:i + 1], st,
                                      return_stats=True)
        assert_close(lo[0, 0], full[0, i].numpy(), rtol=1e-5)
        assert float(stats["moe_drop_frac"]) == 0.0


def test_engine_tokens_and_drop_ring_equal_jax_engine(moe):
    """Five requests on two slots (the fifth reuses a slot), float32:
    every greedy token equal to the JAX engine's, and the
    ``moe_drop_frac`` channel of ``stats()`` equal to the JAX engine's
    (decode steps only; at two slots no decode step can drop)."""
    want, jeng = _serve_jax(moe["jc"], moe["jp"], moe["prompts"])
    got, eng = _serve(moe["tc"], moe["tp"], moe["prompts"])
    assert got == want
    ring, jring = (e.rings["moe_drop_frac"] for e in (eng, jeng))
    np.testing.assert_array_equal(ring.values(), jring.values())
    st, jst = eng.stats()["moe_drop_frac"], jeng.stats()["moe_drop_frac"]
    assert st == jst and st["n"] > 0
    assert set(st) == {"p50", "p95", "p99", "n", "mean"}
    jeng.close()


def test_drop_fraction_is_read_once_a_dispatch(moe, monkeypatch):
    """A decode dispatch of n steps pushes n drop fractions, read to the
    host in one copy after the loop; admissions push none. A dense engine
    has no channel."""
    tc, tp = moe["tc"], moe["tp"]
    eng = ServeEngine(tc, tp, max_batch=2, max_len=MAX_LEN,
                      sampler=SamplerConfig(temperature=0.0), device="cpu")
    eng.submit(Request(rid=0, prompt=moe["prompts"][2], max_new_tokens=9))
    eng._admit()
    assert len(eng.rings["moe_drop_frac"]) == 0
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(self.shape)
                        or real(self, *a, **k))
    eng._decode_n(8)
    monkeypatch.undo()
    assert copies == [(8, 2, 2), (8,)]
    assert len(eng.rings["moe_drop_frac"]) == 8
    _, dense = dense_cfgs("llama3.2-3b")
    deng = ServeEngine(dense, M.init(dense, torch.Generator().manual_seed(0),
                                     device="cpu"), max_batch=2, max_len=32,
                       device="cpu")
    assert "moe_drop_frac" not in deng.stats() and deng.rings == {}


def _greedy_eager(cfg, params, prompt):
    """The JAX package's greedy tokens for one prompt, op by op: prepack,
    the power-of-two chunks, then ``N_NEW - 1`` decode steps."""
    from repro.serving.engine import _pow2_chunks

    with jax.disable_jit():
        p = jM.prepack_params(params, cfg.pim)
        st = jM.init_state(cfg, 1, MAX_LEN)
        pos = 0
        for c in _pow2_chunks(len(prompt)):
            lo, st = jM.prefill(p, cfg, jnp.asarray(prompt[None, pos:pos + c]),
                                st)
            pos += c
        toks = [int(np.asarray(lo)[0, -1].argmax())]
        for _ in range(N_NEW - 1):
            lo, st = jM.decode_step(p, cfg, jnp.asarray([[toks[-1]]]), st)
            toks.append(int(np.asarray(lo)[0, -1].argmax()))
    return toks


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_pim_tokens_equal_eager_jax_at_one_layer(arch):
    """<8:8>, one layer, a 70-token prompt (64 + 4 + 2; the 64-token chunk
    drops at capacity): the port's engine on the ``cuda`` backend (kernel
    2's batched entry and the single one, and kernel 1, as plain versions
    here) gives the greedy tokens of the JAX package run op by op on
    int-direct. One slot, because a decode step calibrates its activations
    over the whole grid."""
    jc, tc = moe_cfgs(arch, n_layers=1)
    jp, tp = moe_params(jc, seed=3)
    jc = dataclasses.replace(jc, pim=JPIMQuantConfig(8, 8,
                                                     backend="int-direct"))
    tc = dataclasses.replace(tc, pim=PIMQuantConfig(8, 8, backend="cuda"))
    prompt = np.random.default_rng(70).integers(0, 512, 70).astype(np.int32)
    got, _ = _serve(tc, tp, [prompt], max_batch=1)
    assert got == {0: _greedy_eager(jc, jp, prompt)}


@pytest.mark.parametrize("arch,extra", [
    (MOE_ARCHS[0], []),
    (MOE_ARCHS[1], ["--precision", "<8:8>", "--backend", "cuda"])])
def test_launcher_serves_moe_on_cpu(capsys, arch, extra):
    tserve.main(["--workload", "lm", "--arch", arch, "--reduced",
                 "--requests", "2", "--max-new", "3", "--device", "cpu",
                 *extra])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out[:2]] == ["req 0", "req 1"]
    assert out[2].startswith("2 completions, 6 tokens in")
