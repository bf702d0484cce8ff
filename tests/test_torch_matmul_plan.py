"""Kernels 2 and 4's launch plan (``kernels/bitserial_matmul.py::_plan``)
at every shape ``chip_smoke.py`` holds them at, and the plain versions'
wrap mod 2^32 against the JAX package once K passes 33,025 (where 255^2 * K
passes 2^31).

The plan decides what the CUDA kernel sums in s32 and what it adds with
uint32 atomics, so it is checked here where no card is: the splits tile
[0, KW) exactly, none sums more than 32,768 K, the grid fills the card
where K has the words for it, and M <= 16 takes the 16-row tile."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_bits_equal, t

from repro.core import bitserial as jbs
from repro_torch.configs import get_config
from repro_torch.kernels import bitserial_matmul as km
from repro_torch.kernels import ops as tops


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()
# The served LMs' <8:8> calls of kernel 2, which the smoke records and
# holds on the card.
_SERVED_LM = {shape for arch, head in _SMOKE.LM_HEADS.items()
              if arch not in _SMOKE.STUB_PATHS
              for shape in _SMOKE.served_lm_matmuls(
                  _SMOKE.LM_PROJ_SHAPES[arch], head,
                  [len(p) for p in _SMOKE.lm_prompts(np, head[1])])}
_SERVED_LM |= {shape for arch in _SMOKE.STUB_PATHS
               for shape in _SMOKE.stub_path_matmuls(arch)}
_SHAPES = sorted({(m, k, n) for m, k, n, *_ in
                  _SMOKE.FUSED_ROWS + _SMOKE.PACKED_ROWS}
                 | {_SMOKE.WRAP_ROW} | _SERVED_LM)
# Beside the smoke rows: a product wide enough to need no split for the
# card's sake, whose K still needs two slabs; K = 0; one word of K.
_EXTRA = [(4096, 40000, 4096), (8, 0, 64), (1, 32, 1)]
H100_SMS = 132
# The batched entry's rows (E, M, K, N): the smoke's timed and ragged rows,
# its wrap row, and phi3.5-moe's served bank calls.
_PHI_LENS = [len(p) for p in _SMOKE.lm_prompts(
    np, _SMOKE.LM_HEADS[_SMOKE.PHI][1])]
_BATCHED = sorted({r[:4] for r in _SMOKE.BATCHED_ROWS}
                  | {_SMOKE.BATCHED_WRAP_ROW}
                  | set(_SMOKE.served_bank_matmuls(
                      get_config(_SMOKE.PHI).model, _PHI_LENS)))


def _grid(plan, m, n):
    """Blocks the kernel launches for ``plan``: (M, N) tiles times splits."""
    bm, bn, _ = km.TILES[plan.variant]
    return -(-m // bm) * -(-n // bn) * plan.splits


@pytest.mark.parametrize("m,k,n", _SHAPES + _EXTRA)
@pytest.mark.parametrize("sms", [H100_SMS, 114])    # SXM and PCIe H100
def test_plan_splits_tile_k_within_slabs(m, k, n, sms):
    kw = -(-k // 32)
    plan = km._plan(m, n, kw, sms)
    bm, bn, kstep = km.TILES[plan.variant]
    # Split s sums words [s * split_words, (s + 1) * split_words) of KW.
    ranges = [(s * plan.split_words, min(kw, (s + 1) * plan.split_words))
              for s in range(plan.splits)]
    assert plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == kw
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges) or (kw == 0 and plan.splits == 1)
    assert all(32 * (hi - lo) <= 32768 for lo, hi in ranges)
    assert plan.split_words % kstep == 0
    assert plan.split_words <= km.SLAB_WORDS
    assert plan.variant == (km.SMALL if m <= 16 else km.LARGE)
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-kw // kstep)
    assert _grid(plan, m, n) >= min(sms, tiles * steps)
    if tiles >= 2 * sms:    # the card is full without splitting
        assert plan.splits == max(1, -(-kw // km.SLAB_WORDS))


@pytest.mark.parametrize("e,m,k,n", _BATCHED)
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_batched_plan_counts_every_experts_tiles(e, m, k, n, sms):
    """The batched entry's plan tiles K as the single plan does, and
    counts the tiles of all E products when it fills the card: a bank
    splits K only where E times one product's tiles leaves SMs idle, and
    the grid's z (E times the splits) stays within 65,535."""
    kw = -(-k // 32)
    plan = km._plan(m, n, kw, sms, e)
    bm, bn, kstep = km.TILES[plan.variant]
    ranges = [(s * plan.split_words, min(kw, (s + 1) * plan.split_words))
              for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == kw
    assert all(lo < hi for lo, hi in ranges)
    assert all(32 * (hi - lo) <= 32768 for lo, hi in ranges)
    assert plan.variant == (km.SMALL if m <= 16 else km.LARGE)
    assert e * plan.splits <= 65535
    tiles = e * -(-m // bm) * -(-n // bn)
    steps = -(-kw // kstep)
    assert tiles * plan.splits >= min(sms, tiles * steps)
    if tiles >= 2 * sms:
        assert plan.splits == max(1, -(-kw // km.SLAB_WORDS))
    assert km._plan(m, n, kw, sms) == km._plan(m, n, kw, sms, 1)
    if e > 1 and tiles < 2 * sms * e:       # one product alone splits more
        assert km._plan(m, n, kw, sms).splits >= plan.splits


def test_phi_decode_bank_fills_the_card_without_a_split():
    """phi3.5-moe's decode bank (16 experts, 8 rows, 4096 x 6400): 800
    tiles over 132 SMs, so no split; alone, one expert's 50 tiles would
    split K."""
    plan = km._plan(8, 6400, 128, H100_SMS, 16)
    assert plan.variant == km.SMALL and plan.splits == 1
    assert km._plan(8, 6400, 128, H100_SMS).splits > 1


def test_plan_picks_both_paths_on_the_served_shapes():
    """The served shapes reach both tiles, with and without a split: decode
    M = 4 splits K, ResNet-50's 1x1 at M = 25,088 does not."""
    dec = km._plan(4, 2560, 80, H100_SMS)
    assert dec.variant == km.SMALL and dec.splits > 1
    assert _grid(dec, 4, 2560) >= H100_SMS
    res = km._plan(8 * 56 * 56, 64, 8, H100_SMS)
    assert res.variant == km.LARGE and res.splits == 1
    wrap = km._plan(*_SMOKE.WRAP_ROW[::2], 1250, H100_SMS)
    assert wrap.splits > 1


@pytest.mark.parametrize("m,k,n", [(2, 40000, 3), (3, 33056, 5)])
def test_plain_versions_wrap_like_the_reference(m, k, n):
    """All codes 255 at <8:8>: P = 65,025 * K passes 2^31 and wraps mod
    2^32 in both plain versions exactly as the JAX package's int32
    ``int_matmul_direct`` does."""
    qa = np.full((m, k), 255, np.int32)
    qw = np.full((k, n), 255, np.int32)
    want = jbs.int_matmul_direct(jnp.asarray(qa), jnp.asarray(qw))
    p = 65025 * k % 2**32
    assert int(want[0, 0]) == p - 2**32 * (p >= 2**31) < 0
    pw = tops.pack_planes(t(np.ascontiguousarray(qw.T)), 8)
    assert_bits_equal(km.bitserial_matmul_fused_plain(t(qa), pw, 8, 8), want)
    assert_bits_equal(km.packed_matmul_plain(tops.pack_planes(t(qa), 8), pw),
                      want)
    assert_bits_equal(tops.bitserial_matmul(t(qa), a_bits=8, w_bits=8, pw=pw),
                      want)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "llama3.2-3b",
                                  "recurrentgemma-9b", "phi3.5-moe-42b-a6.6b"])
def test_served_lm_matmuls_are_the_engines_calls(arch):
    """``arch`` reduced, <8:8> on "cuda" (the plain versions on the CPU),
    five prompts on the smoke's ``LM_MAX_BATCH`` slots: the kernel-2 calls
    the smoke's ``recorded_matmuls`` keeps are ``served_lm_matmuls`` of the
    prompts, the projections (each prepacked leaf but the head and the
    expert banks) and the head; and the batched entry's calls are
    ``served_bank_matmuls`` (none without MoE)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig
    from repro_torch.models.lm import model as M
    from repro_torch.serving import Request, SamplerConfig, ServeEngine

    cfg = dataclasses.replace(get_config(arch).model.reduced(),
                              dtype="float32",
                              pim=PIMQuantConfig(8, 8, backend="cuda"))
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, params, max_batch=_SMOKE.LM_MAX_BATCH, max_len=64,
                      sampler=SamplerConfig(temperature=0.0), device="cpu")
    # Chunks 32+4+1, 8+2+1, 2+1, 16+4+1 and 32+16+2; the fifth reuses a slot.
    lens = (37, 11, 3, 21, 50)
    rng = np.random.default_rng(0)
    for rid, n in enumerate(lens):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                           max_new_tokens=3))
    with _SMOKE.recorded_matmuls() as rec:
        assert len(eng.run(strict=True)) == len(lens)
    head = (cfg.d_model, cfg.vocab)
    proj = {w.shape for _, w in _SMOKE._packed_leaves(eng.params)
            if not w.is_bank} - {head}
    got = sorted((qa.shape[0], qa.shape[1], pw.shape[1])
                 for qa, pw, _ in rec.calls.values())
    assert got == _SMOKE.served_lm_matmuls(proj, head, lens)
    got = sorted((*qa.shape, pw.shape[2]) for qa, pw, _ in
                 rec.bank_calls.values())
    assert got == (_SMOKE.served_bank_matmuls(cfg, lens) if cfg.moe else [])
    if cfg.moe:    # capacity 24 at 32-token chunks, 16 at 16, 8 below
        assert {m for _, m, _, _ in got} == {8, 16, 24}


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-90b"])
def test_served_stub_matmuls_are_the_model_functions_calls(arch):
    """``arch`` reduced, <8:8> on "cuda" (the plain versions on the CPU),
    driven as the smoke drives it on the card (a batch prefill of two
    prompts of 8 frames or tokens, then three decode steps, one image a row
    at every call): the kernel-2 calls the smoke's ``recorded_matmuls``
    keeps are ``served_stub_matmuls`` of the projections, the head and,
    for the vision arch, the cross layers' wk / wv on the image tokens;
    and at the card's paths ``stub_path_matmuls`` lists each projection
    shape of ``LM_PROJ_SHAPES``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig
    from repro_torch.models.lm import model as M

    cfg = dataclasses.replace(get_config(arch).model.reduced(),
                              dtype="float32",
                              pim=PIMQuantConfig(8, 8, backend="cuda"))
    params = M.prepack_params(M.init(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"), cfg.pim)
    rng = np.random.default_rng(1)
    d, b, s = cfg.d_model, 2, 8
    img = None
    if cfg.embed_inputs:
        x = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
        img = torch.randn(b, cfg.n_image_tokens, d)
    else:
        x = torch.randn(b, s, d)
    st = M.init_state(cfg, b, 32, device="cpu")
    with _SMOKE.recorded_matmuls() as rec, torch.no_grad():
        lo, st = M.prefill(params, cfg, x, st, image_embeds=img)
        for _ in range(3):
            nxt = lo[:, -1].argmax(-1)[:, None] if cfg.embed_inputs \
                else torch.randn(b, 1, d)
            lo, st = M.decode_step(params, cfg, nxt, st, image_embeds=img)
    head = (d, cfg.vocab)
    proj = {w.shape for _, w in _SMOKE._packed_leaves(params)} - {head}
    hkv = cfg.n_kv_heads * cfg.head_dim
    cross = (d, hkv) if cfg.cross_attn_every else None
    got = sorted((qa.shape[0], qa.shape[1], pw.shape[1])
                 for qa, pw, _ in rec.calls.values())
    assert got == _SMOKE.served_stub_matmuls(proj, head, b, s, cross,
                                             cfg.n_image_tokens)
    assert not rec.bank_calls
    full = get_config(arch).model
    assert set(_SMOKE.LM_PROJ_SHAPES[arch]) == {
        (full.d_model, full.n_heads * full.head_dim),
        (full.d_model, full.n_kv_heads * full.head_dim),
        (full.n_heads * full.head_dim, full.d_model),
        (full.d_model, full.d_ff), (full.d_ff, full.d_model)}
    assert _SMOKE.LM_HEADS[arch] == (full.d_model, full.vocab)
