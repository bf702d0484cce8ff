"""Port parity, VGG19 at its published widths: the port's VGG19 on the
``popcount`` and ``cuda`` backends (plain versions of the kernels) and in
float against the JAX package run op by op, and the parameter tree carried
across.

32 px, the smallest size its five pools leave a 1x1 map at; every width is
the published one, only the image and so fc1's input shrink. Batch 2,
<4:4> (16 plane pairs: the plain popcount at <8:8> is four times the
time). The JAX side runs ``int-direct`` (its P is bit-identical to its
other backends here) under ``jax.disable_jit``. Logits agree to rtol 1e-4
with an absolute floor of 1e-4*max|logit| and top-1 is equal, as in
tests/test_torch_alexnet.py."""
import jax
import pytest
import torch

from _torch_parity import check_cnn_logits, check_tree_carried, cnn_reference

from repro.models.cnn import vgg as jvgg
from repro_torch import convert
from repro_torch.models.cnn import vgg as tvgg


@pytest.fixture(scope="module")
def ref():
    out = cnn_reference(jvgg, image=32, bits=4)
    out["params"] = convert.params_from_jax(jax.device_get(out["jparams"]))
    return out


@pytest.mark.parametrize("backend", [None, "popcount", "cuda"])
def test_vgg19_logits_match_jax(ref, backend):
    check_cnn_logits(tvgg, ref, ref["params"], backend)


def test_vgg19_params_from_jax(ref):
    check_tree_carried(ref["jparams"], ref["params"], tvgg.init(
        torch.Generator().manual_seed(0), num_classes=10, image=32))
