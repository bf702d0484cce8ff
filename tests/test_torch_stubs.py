"""The port's modality-frontend stubs and musicgen-large's
``embed_inputs=False`` path against the JAX package on the CPU: the stubs'
shapes, dtypes, scale and determinism; musicgen-large's config and tree
(no embedding), and its forward, prefill and decode step on frame
embeddings (MHA, the tanh gelu, layernorm) in float32, bf16 and <8:8>.

Torch draws other numbers than JAX for the same seed, so the comparisons
pass the same numpy frames to both packages; the stubs' own draws are
tested for their distribution only.
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
from repro.models.lm import stubs as jstubs
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import PIMQuantConfig
from repro_torch.models.lm import (audio_frame_embeddings,
                                   image_patch_embeddings)
from repro_torch.models.lm import model as M

from _torch_parity import assert_close, normal, rel_err, stub_cfgs, \
    stub_params, t

MUSICGEN = "musicgen-large"
S = 12


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def musicgen():
    """Reduced musicgen-large in float32, one set of weights in both
    packages, and frames for two sequences: ``S`` prompt frames, then the
    frames of four decode steps."""
    jc, tc = stub_cfgs(MUSICGEN)
    jp, tp = stub_params(jc)
    frames = normal(np.random.default_rng(40), (2, S + 4, jc.d_model), 0.1)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, frames=frames)


def _greedy(pkg, cfg, params, frames, n_prompt, eager=False):
    """Prefill the first ``n_prompt`` frames, then one decode step on each
    later frame (the codebook frontend is a stub: the sampled codes are
    read, not fed back). Returns each call's logits as numpy."""
    if pkg is jM:
        conv, state = jnp.asarray, jM.init_state(cfg, frames.shape[0], 32)
    else:
        conv, state = t, M.init_state(cfg, frames.shape[0], 32, device="cpu")
    ctx = jax.disable_jit() if eager else torch.no_grad()
    out = []
    with ctx:
        p = pkg.prepack_params(params, cfg.pim) if cfg.pim else params
        lo, state = pkg.prefill(p, cfg, conv(frames[:, :n_prompt]), state)
        out.append(np.asarray(lo, np.float32))
        for i in range(n_prompt, frames.shape[1]):
            lo, state = pkg.decode_step(p, cfg, conv(frames[:, i:i + 1]),
                                        state)
            out.append(np.asarray(lo, np.float32))
    return out


# -- the stubs -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stub_shapes_dtypes_and_scale(dtype):
    """(B, n_image_tokens, d_model) patches and (B, S, d_model) frames in
    the dtype asked for, normal draws times d_model**-0.5 (the JAX stubs'
    scale: their own draws' std is within the same 3%)."""
    cfg = get_config("llama-3.2-vision-90b").model.reduced(d_model=256,
                                                           n_image_tokens=64)
    img = image_patch_embeddings(cfg, 3, dtype=dtype, device="cpu")
    frames = audio_frame_embeddings(cfg, 2, 40, dtype=dtype, device="cpu")
    assert img.shape == (3, 64, 256) and img.dtype == dtype
    assert frames.shape == (2, 40, 256) and frames.dtype == dtype
    ref_cfg = jget_config("llama-3.2-vision-90b").model.reduced(
        d_model=256, n_image_tokens=64)
    ref = np.asarray(jstubs.image_patch_embeddings(ref_cfg, 3), np.float32)
    for x in (img.float().numpy(), frames.float().numpy(), ref):
        assert abs(float(x.std()) * 256**0.5 - 1) < 0.03
        assert abs(float(x.mean())) * 256**0.5 < 0.03


def test_stubs_are_deterministic_per_seed():
    """One seed gives the same draws (the defaults: 0 for the patches, 1
    for the frames, as the JAX stubs' keys); another seed others; a
    generator given draws from itself, and a CPU draw cast to bf16 is the
    float32 draw rounded."""
    cfg = get_config("llama-3.2-vision-90b").model.reduced()

    def img(**kw):
        return image_patch_embeddings(cfg, 2, device="cpu", **kw)

    def frames(**kw):
        return audio_frame_embeddings(cfg, 2, 8, device="cpu", **kw)

    assert torch.equal(img(), img())
    assert torch.equal(frames(), frames())
    assert torch.equal(img(generator=torch.Generator().manual_seed(0)), img())
    assert torch.equal(frames(generator=torch.Generator().manual_seed(1)),
                       frames())
    assert not torch.equal(img(generator=torch.Generator().manual_seed(5)),
                           img())
    assert not torch.equal(frames(generator=torch.Generator().manual_seed(0)),
                           frames())
    f32 = img(dtype=torch.float32)
    assert torch.equal(img(), f32.to(torch.bfloat16))


# -- musicgen-large ----------------------------------------------------------------

def test_musicgen_config_matches_jax():
    """The published config (48 layers of MHA, the tanh gelu, layernorm,
    2,048 codes, frame inputs) and its reduced form, as in the JAX
    package; ``n_params`` counts an embedding that the frame-input tree
    never makes, in both packages."""
    jarch, tarch = jget_config(MUSICGEN), get_config(MUSICGEN)
    assert dataclasses.asdict(tarch.model) == dataclasses.asdict(jarch.model)
    assert (tarch.arch_id, tarch.source, tarch.notes) == (
        jarch.arch_id, jarch.source, jarch.notes)
    m = tarch.model
    assert (m.n_layers, m.d_model, m.n_heads, m.n_kv_heads, m.head_dim,
            m.d_ff, m.vocab, m.act, m.norm, m.embed_inputs) == (
        48, 2048, 32, 32, 64, 8192, 2048, "gelu", "layernorm", False)
    assert dataclasses.asdict(m.reduced()) == dataclasses.asdict(
        jarch.model.reduced())
    assert M.layer_plan(m) == jM.layer_plan(jarch.model) == (("attn",), 48,
                                                            ())
    assert m.n_params() == jarch.model.n_params()


def test_musicgen_tree_has_no_embedding(musicgen):
    """No ``embed`` leaf (frames come in), an untied head, the JAX tree's
    shapes; ``params_from_jax`` carries a tree without an embedding."""
    tc, jp = musicgen["tc"], musicgen["jp"]
    own = M.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert "embed" not in own and "embed" not in jp
    assert own["head"].shape == (tc.d_model, tc.vocab)
    carried = convert.params_from_jax(jp)
    assert set(carried) == set(own) == {"scan", "rest", "final_norm", "head"}
    assert carried["scan"][0]["norm1"]["bias"].shape == (tc.n_layers,
                                                        tc.d_model)
    assert carried["scan"][0]["attn"]["wk"].shape == (
        tc.n_layers, tc.d_model, tc.n_kv_heads * tc.head_dim)


def test_musicgen_forward_matches_jax(musicgen):
    """Float32 frames in: forward logits within rtol 1e-5 of the JAX
    package's."""
    d = musicgen
    x = d["frames"][:, :S]
    want, _ = jM.forward(d["jp"], d["jc"], jnp.asarray(x))
    got, aux = M.forward(d["tp"], d["tc"], t(x))
    assert got.shape == (2, S, d["tc"].vocab) and float(aux) == 0.0
    assert_close(got, want, rtol=1e-5)


def test_musicgen_prefill_and_decode_match_jax(musicgen):
    """Prefill ``S`` frames, then four decode steps on the next frames:
    each call's logits within 1e-5 of the JAX package's, and the first
    step's within 1e-4 of forward's at that position."""
    d = musicgen
    got = _greedy(M, d["tc"], d["tp"], d["frames"], S)
    want = _greedy(jM, d["jc"], d["jp"], d["frames"], S)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-5)
    full, _ = M.forward(d["tp"], d["tc"], t(d["frames"][:, :S + 1]))
    assert_close(got[1][:, 0], full[:, -1], rtol=1e-4)


def test_musicgen_bf16_close_to_jax(musicgen):
    """bf16 weights and bf16 frames: forward and each decode call within
    10% of the largest logit, with the same last token (``ROADMAP.md``
    Queue 3)."""
    d = musicgen
    jc, tc = (dataclasses.replace(c, dtype="bfloat16")
              for c in (d["jc"], d["tc"]))
    jp = jax.device_get(jM.cast_params(d["jp"], jnp.bfloat16))
    tp = M.cast_params(d["tp"], torch.bfloat16)
    x = d["frames"][:, :S]
    want, _ = jM.forward(jp, jc, jnp.asarray(x).astype(jnp.bfloat16))
    got, _ = M.forward(tp, tc, t(x).to(torch.bfloat16))
    assert rel_err(got, want) < 1e-1
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  np.asarray(want)[:, -1].argmax(-1))
    for g, w in zip(_greedy(M, tc, tp, d["frames"], S),
                    _greedy(jM, jc, jp, d["frames"], S)):
        assert rel_err(g, w) < 1e-1
        np.testing.assert_array_equal(g[:, -1].argmax(-1),
                                      w[:, -1].argmax(-1))


def test_musicgen_pim_codes_equal_eager_jax_at_one_layer():
    """<8:8> at one layer (the PIM path is chaotic deeper; ``ROADMAP.md``
    Queue 3): every projection and the head prepacked, the port on the
    ``cuda`` backend (kernels 1-2's plain versions here) against the JAX
    package run op by op on int-direct; the greedy codes of the prefill
    and of four decode steps equal, the logits within 0.1 of the
    largest."""
    jc, tc = stub_cfgs(MUSICGEN, n_layers=1)
    jp, tp = stub_params(jc, seed=1)
    jc = dataclasses.replace(jc, pim=JPIMQuantConfig(8, 8,
                                                     backend="int-direct"))
    tc = dataclasses.replace(tc, pim=PIMQuantConfig(8, 8, backend="cuda"))
    frames = normal(np.random.default_rng(41), (2, S + 4, jc.d_model), 0.1)
    got = _greedy(M, tc, tp, frames, S)
    want = _greedy(jM, jc, jp, frames, S, eager=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:, -1].argmax(-1),
                                      w[:, -1].argmax(-1))
        assert rel_err(g, w) < 1e-1
