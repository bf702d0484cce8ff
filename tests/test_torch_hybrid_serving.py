"""recurrentgemma-9b through the port's whole model and ``ServeEngine``
against the JAX package on the CPU, and prepacked codes kept as bytes.

The model runs at its ``reduced()`` width (4 layers: rglru, rglru,
local_attn, rglru; d_model 128; one KV head of 32; lru_width 128; window
64; vocab 512): forward logits in float32 within 1e-5 of the largest, and
bf16 (11 layers: three scanned units and two remainder rglru layers)
within 10% with the same last token; the engine's greedy tokens equal the
(jitted) JAX engine's with prompts longer than the window, chunked
admission, slot reuse and cancel; ``<8:8>`` tokens at one layer of each
kind (the PIM LM path is chaotic deeper, ``ROADMAP.md`` Queue 3); the
launcher. Then ``PackedWeight.codes`` as ``uint8`` at <= 8 bits: the
widened codes are the JAX package's, and every backend's product and
``to_float`` are unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PIMQuantConfig as JPIMQuantConfig
from repro.core import packed as jpk
from repro.models.lm import model as jM
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSamplerConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.core import PIMQuantConfig, bitserial, packed, pim_layers
from repro_torch.launch import serve as tserve
from repro_torch.models.lm import model as M
from repro_torch.serving import Request, SamplerConfig, ServeEngine

from _torch_parity import (assert_bits_equal, assert_close, hybrid_cfgs,
                           hybrid_params, normal, rel_err, t)

# Prompts longer than the window of 64 and shorter: 150 = 128+16+4+2,
# 70 = 64+4+2, 97 = 64+32+1 (a one-token chunk takes the step path),
# 13 = 8+4+1, 41 = 32+8+1.
PROMPT_LENS = (150, 70, 97, 13, 41)
N_NEW = 6
MAX_LEN = 192


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hybrid():
    """reduced recurrentgemma-9b, float32, one set of weights in both
    packages, and the prompts."""
    jc, tc = hybrid_cfgs()
    jp, tp = hybrid_params(jc, seed=1)
    prompts = [np.random.default_rng(40 + i).integers(
        0, tc.vocab, size=n).astype(np.int32) for i, n in enumerate(
            PROMPT_LENS)]
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts)


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


# -- whole model ---------------------------------------------------------------------

def test_forward_logits_match_jax(hybrid):
    """100 tokens (past the window) through the four layers."""
    toks = np.random.default_rng(3).integers(0, 512, (2, 100)).astype(
        np.int32)
    want = jax.jit(lambda p, x: jM.forward(p, hybrid["jc"], x)[0])(
        hybrid["jp"], jnp.asarray(toks))
    got, aux = M.forward(hybrid["tp"], hybrid["tc"], t(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert_close(got, np.asarray(want), rtol=1e-5)


def test_bf16_forward_close_to_jax():
    """bf16 at 11 layers: the stacked lam/b_a/b_i in bf16, the two
    remainder layers' in float32. Within 10% of the largest logit (the
    reference's own jit and eager runs part by ~4.5% here) and the same
    last token."""
    jc, tc = hybrid_cfgs(n_layers=11, dtype="bfloat16")
    jp, tp = hybrid_params(jc, seed=2, dtype=jnp.bfloat16)
    toks = np.random.default_rng(4).integers(0, 512, (2, 80)).astype(
        np.int32)
    want = np.asarray(jax.jit(lambda p, x: jM.forward(p, jc, x)[0])(
        jp, jnp.asarray(toks)))
    got, _ = M.forward(tp, tc, t(toks))
    assert got.dtype == torch.float32
    assert rel_err(got, want) < 1e-1
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  want[:, -1].argmax(-1))


def test_prefill_and_decode_match_forward(hybrid):
    """Chunked prefill (64 + 16 + 1: a window-long chunk, one past it, a
    one-token step) and 12 decode steps give the forward's logits at each
    position: the RG-LRU carries and the ring hold what a full pass
    recomputes."""
    tc, tp = hybrid["tc"], hybrid["tp"]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (1, 93)).astype(np.int64))
    full, _ = M.forward(tp, tc, toks)
    st = M.init_state(tc, 1, 128, device="cpu")
    pos = 0
    for c in (64, 16, 1):
        lo, st = M.prefill(tp, tc, toks[:, pos:pos + c], st)
        pos += c
        assert_close(lo[0, 0], full[0, pos - 1].numpy(), rtol=1e-5)
    for i in range(pos, 93):
        lo, st = M.decode_step(tp, tc, toks[:, i:i + 1], st)
        assert_close(lo[0, 0], full[0, i].numpy(), rtol=1e-5)
    assert st["length"].tolist() == [93]


# -- the engine ----------------------------------------------------------------------

def test_engine_greedy_tokens_equal_jax_engine(hybrid):
    """Five requests on two slots, float32, prompts past the window and a
    one-token chunk among the chunks: every greedy token equal to the JAX
    engine's."""
    want = _serve_jax(hybrid["jc"], hybrid["jp"], hybrid["prompts"])
    assert _serve(hybrid["tc"], hybrid["tp"], hybrid["prompts"]) == want


def test_slot_reuse_leaks_no_carry_or_ring_row(hybrid):
    """Prefilling B into a slot A used gives the logits of a fresh grid bit
    for bit, and leaves no RG-LRU carry, conv input or ring row of A."""
    tc, tp = hybrid["tc"], hybrid["tp"]
    a = t(hybrid["prompts"][0][None])       # 150 tokens: fills the ring
    b = t(hybrid["prompts"][3][None])       # 13 tokens
    fresh = M.init_state(tc, 2, MAX_LEN, device="cpu")
    want, fresh = M.prefill_into_slot(tp, tc, b, fresh, 0, 0)
    dirty = M.init_state(tc, 2, MAX_LEN, device="cpu")
    _, dirty = M.prefill_into_slot(tp, tc, a, dirty, 0, 0)
    got, dirty = M.prefill_into_slot(tp, tc, b, dirty, 0, 0)
    assert torch.equal(got, want)
    for d, f in zip(dirty["scan"], fresh["scan"]):
        for k in d:
            assert torch.equal(d[k], f[k]), k
    ring = dirty["scan"][tc.blocks.index("local_attn")]
    assert not ring["k"][:, 0, 13:].any()


def test_cancel_slot_reuse(hybrid):
    """The request that inherits a cancelled slot (mid-generation, past
    the window) matches a fresh engine's run exactly."""
    tc, tp = hybrid["tc"], hybrid["tp"]
    p_a, p_b = hybrid["prompts"][1], hybrid["prompts"][4]
    want = _serve(tc, tp, [p_b], max_batch=1)[0]
    eng = _engine(tc, tp, max_batch=1, drain_steps=1)
    eng.submit(Request(rid=1, prompt=p_a, max_new_tokens=12))
    eng.step()
    eng.step()
    assert eng.cancel(1) == "active"
    eng.submit(Request(rid=2, prompt=p_b, max_new_tokens=N_NEW))
    done = eng.run()
    assert [c.rid for c in done] == [2] and done[0].tokens == want


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


@pytest.mark.parametrize("kind", ["rglru", "local_attn"])
def test_engine_pim_tokens_equal_eager_jax_at_one_layer(kind):
    """<8:8>, one layer of each kind, a 65-token prompt (64 + 1: past the
    window, and a one-token chunk): the port's engine on the ``cuda``
    backend (kernels 1-2's plain versions here) gives the greedy tokens of
    the JAX package run op by op on int-direct. Not the jitted JAX engine:
    on a 33-token prompt with ``local_attn`` it parts from its own eager
    run at the first token (the path is chaotic, and the port follows the
    eager arithmetic). One slot, because a decode step calibrates its
    activations over the whole grid, which couples one request's float
    jitter to another's codes."""
    jc, tc = hybrid_cfgs(n_layers=1, block_pattern=(kind,))
    jp, tp = hybrid_params(jc, seed=3)
    jc = dataclasses.replace(jc, pim=JPIMQuantConfig(8, 8,
                                                     backend="int-direct"))
    tc = dataclasses.replace(tc, pim=PIMQuantConfig(8, 8, backend="cuda"))
    prompt = np.random.default_rng(50).integers(0, 512, 65).astype(np.int32)
    assert _serve(tc, tp, [prompt], max_batch=1) == {
        0: _greedy_eager(jc, jp, prompt)}


def test_bf16_engine_keeps_float32_carries(hybrid):
    """A bf16 engine keeps the ring in bf16 and the RG-LRU state in
    float32, and serves."""
    tc = dataclasses.replace(hybrid["tc"], dtype="bfloat16")
    eng = _engine(tc, M.cast_params(hybrid["tp"], torch.bfloat16))
    ring = eng.state["scan"][tc.blocks.index("local_attn")]
    assert ring["k"].dtype == torch.bfloat16
    assert eng.state["scan"][0]["h"].dtype == torch.float32
    eng.submit(Request(rid=0, prompt=hybrid["prompts"][1], max_new_tokens=4))
    (c,) = eng.run(strict=True)
    assert len(c.tokens) == 4 and all(0 <= x < tc.vocab for x in c.tokens)


@pytest.mark.parametrize("extra", [[], ["--precision", "<8:8>",
                                        "--backend", "cuda"]])
def test_launcher_serves_recurrentgemma_on_cpu(capsys, extra):
    tserve.main(["--workload", "lm", "--arch", "recurrentgemma-9b",
                 "--reduced", "--requests", "2", "--max-new", "3",
                 "--device", "cpu", *extra])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out[:2]] == ["req 0", "req 1"]
    assert out[2].startswith("2 completions, 6 tokens in")


# -- codes as bytes ----------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 5, 8, 9, 12, 16])
def test_prepack_keeps_codes_as_bytes_up_to_8_bits(bits):
    """uint8 at 1-8 bits, int32 at 9-16; the widened codes, planes and
    column sums are the JAX package's, and ``to_float`` too."""
    w = normal(np.random.default_rng(bits), (70, 33))
    jp, tp = jpk.prepack(jnp.asarray(w), bits), packed.prepack(t(w), bits)
    assert tp.codes.dtype == (torch.uint8 if bits <= 8 else torch.int32)
    assert tp.codes32.dtype == torch.int32
    assert_bits_equal(tp.codes32, jp.codes)
    assert_bits_equal(tp.planes, jp.planes)
    assert_bits_equal(tp.col_sums, jp.col_sums)
    assert_bits_equal(tp.to_float(), jp.to_float())
    conv = packed.prepack_conv(t(normal(np.random.default_rng(bits + 1),
                                        (3, 3, 5, 7))), bits)
    assert conv.mat.codes.dtype == tp.codes.dtype


@pytest.mark.parametrize("backend", bitserial.BACKENDS)
def test_byte_codes_leave_every_backend_unchanged(backend):
    """Each backend's P, the linear layer and a padded conv on the im2col
    route (its border correction reads the codes) give the same result
    from byte codes as from the same codes widened to int32."""
    rng = np.random.default_rng(6)
    x, w = normal(rng, (5, 70)), normal(rng, (70, 33))
    tp = packed.prepack(t(w), 8)
    wide = dataclasses.replace(tp, codes=tp.codes32)
    qa = t(rng.integers(0, 256, (5, 70)).astype(np.int32))
    assert torch.equal(bitserial.int_matmul_prepacked(qa, tp, 8, backend),
                       bitserial.int_matmul_prepacked(qa, wide, 8, backend))
    cfg = PIMQuantConfig(8, 8, backend=backend)
    assert torch.equal(pim_layers.pim_linear(t(x), tp, cfg=cfg),
                       pim_layers.pim_linear(t(x), wide, cfg=cfg))
    img = t(normal(rng, (1, 6, 6, 5)))
    pc = packed.prepack_conv(t(normal(rng, (3, 3, 5, 7))), 8)
    pc_wide = dataclasses.replace(pc, mat=dataclasses.replace(
        pc.mat, codes=pc.mat.codes32))
    assert pc.mat.codes.dtype == torch.uint8
    for mode in ("im2col", "fused") if backend == "cuda" else ("im2col",):
        assert torch.equal(
            pim_layers.pim_conv2d(img, pc, padding=1, cfg=cfg,
                                  conv_mode=mode),
            pim_layers.pim_conv2d(img, pc_wide, padding=1, cfg=cfg,
                                  conv_mode=mode))
    assert torch.equal(pc.to_float(), pc_wide.to_float())
