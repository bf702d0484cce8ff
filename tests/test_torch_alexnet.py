"""Port parity, AlexNet at its published widths: the port's AlexNet on each
Eq. 1 backend (plain versions of the kernels) against the JAX package run
op by op, the parameter tree carried across, and the engine and launcher
serving it.

64 px is the smallest size AlexNet's three pools leave a 1x1 map at; every
width is the published one, only the image and so fc1's input shrink.
Batch 2, <8:8>. The JAX side runs ``int-direct`` (its P is bit-identical to
its other backends here) under ``jax.disable_jit``. Logits agree to rtol
1e-4 with an absolute floor of 1e-4*max|logit| (the tolerance of
tests/test_torch_vision.py: the integer P is exact on both sides, the
float epilogues reduce in another order) and top-1 is equal."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import check_cnn_logits, check_tree_carried, cnn_reference

from repro.models.cnn import alexnet as jalexnet
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models.cnn import alexnet as talexnet
from repro_torch.serving import VisionEngine, VisionRequest


@pytest.fixture(scope="module")
def ref():
    out = cnn_reference(jalexnet, image=64, bits=8)
    out["params"] = convert.params_from_jax(jax.device_get(out["jparams"]))
    return out


@pytest.mark.parametrize("backend", [None, "popcount", "cuda", "int-direct",
                                     "mxu-plane"])
def test_alexnet_logits_match_jax(ref, backend):
    check_cnn_logits(talexnet, ref, ref["params"], backend)


def test_alexnet_params_from_jax(ref):
    check_tree_carried(ref["jparams"], ref["params"], talexnet.init(
        torch.Generator().manual_seed(0), num_classes=10, image=64))


def test_engine_serves_alexnet_on_each_backend():
    """Through ``VisionEngine`` every backend gives the same logits (their P
    is bit-identical), in buckets 2 + 1."""
    params = talexnet.init(torch.Generator().manual_seed(0), num_classes=5,
                           image=64)
    imgs = np.random.default_rng(3).standard_normal(
        (3, 64, 64, 3)).astype(np.float32)
    logits = {}
    for backend in ("cuda", "popcount", "mxu-plane", "int-direct"):
        eng = VisionEngine({"alexnet": params}, backend=backend, max_batch=2,
                           device="cpu")
        for rid in range(3):
            eng.submit(VisionRequest(rid=rid, image=imgs[rid],
                                     model="alexnet", precision="<4:4>"))
        done = sorted(eng.run(strict=True), key=lambda c: c.rid)
        assert [c.batch for c in done] == [2, 2, 1]
        logits[backend] = np.stack([c.logits for c in done])
    for backend, got in logits.items():
        assert np.array_equal(got, logits["cuda"]), backend


def test_launcher_serves_alexnet_on_popcount(capsys):
    tserve.main(["--workload", "cnn", "--cnn-model", "alexnet", "--image",
                 "64", "--classes", "7", "--requests", "3", "--max-batch",
                 "2", "--backend", "popcount", "--precision", "<4:4>",
                 "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("req 0: top1=") and "(bucket 2)" in out[0]
    assert "model=alexnet@64px, precision=<4:4>, backend=popcount)" in out[-1]
