"""``ServeEngine.n_free_slots`` against the JAX engine's property on the
CPU: both engines take the same requests on the same grid and are stepped
in turns, and the property is compared at every queue and slot state they
pass through (reduced qwen3-0.6b, float32)."""
import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSamplerConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.serving import Request, SamplerConfig, ServeEngine

from _torch_parity import dense_models


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_n_free_slots_equals_jax_engine():
    """Five requests with budgets of 1-6 tokens on three slots: after each
    submit, each step, a cancel of a queued and of an active request, and
    the drain, the port's ``n_free_slots`` (free slots less queued
    requests, never below 0) equals the JAX engine's; the slots and the
    queue are the same in both."""
    d = dense_models(("qwen3-0.6b",))["qwen3-0.6b"]
    rng = np.random.default_rng(60)
    budgets = (4, 1, 6, 2, 3)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 3, 9, 2, 7)]
    jeng = JServeEngine(d["jc"], d["jp"], max_batch=3, max_len=32,
                        sampler=JSamplerConfig(temperature=0.0))
    eng = ServeEngine(d["tc"], d["tp"], max_batch=3, max_len=32,
                      sampler=SamplerConfig(temperature=0.0), device="cpu")
    seen = []

    def same():
        state = ([r is None for r in eng.slot_req], [r.rid for r in eng.queue])
        assert state == ([r is None for r in jeng.slot_req],
                         [r.rid for r in jeng.queue])
        assert eng.n_free_slots == jeng.n_free_slots
        seen.append(eng.n_free_slots)

    same()
    for rid, (p, n) in enumerate(zip(prompts, budgets)):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=n))
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=n))
        same()
    for _ in range(2):
        jeng.step()
        eng.step()
        same()
    active = next(r.rid for r in eng.slot_req if r is not None)
    for rid in (active, eng.queue[-1].rid if eng.queue else active):
        assert eng.cancel(rid) == jeng.cancel(rid)
        same()
    for _ in range(12):
        jeng.step()
        eng.step()
        same()
    assert seen[0] == 3 and seen[-1] == 3 and min(seen) == 0
    with pytest.raises(AttributeError):
        eng.n_free_slots = 1
