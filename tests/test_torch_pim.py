"""Port parity, the paper's pipeline around the models: the layer specs of
AlexNet, VGG19 and ResNet-50 and the NAND-SPIN simulator's prices of them
field for field (exact equality: both are host arithmetic on the same
numbers), the paper's CNN configurations, and the two example twins
(``examples/torch_*.py``) on the CPU. The models' logits are held against
the JAX package in tests/test_torch_{alexnet,vgg,vision}.py."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.models.cnn import specs as jspecs
from repro.pim import simulator as jsim
from repro_torch.configs import CONFIGS, WI_SWEEP
from repro_torch.models.cnn import MODELS
from repro_torch.models.cnn import specs as tspecs
from repro_torch.pim import simulator as tsim

_REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("batch,image", [(1, 224), (8, 224), (2, 64)])
@pytest.mark.parametrize("model", ["alexnet", "vgg19", "resnet50"])
def test_layer_specs_match_jax(model, batch, image):
    got = tspecs.model_specs(model, batch=batch, image=image)
    want = jspecs.model_specs(model, batch=batch, image=image)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert tspecs.total_macs(got) == jspecs.total_macs(want)


def _sim_fields(r):
    return dict(phases={p: (c.latency, c.energy) for p, c in r.phases.items()},
                latency=r.latency, energy=r.energy, fps=r.fps,
                geometry=dataclasses.asdict(r.geometry), ab=r.ab, wb=r.wb,
                latency_breakdown=r.latency_breakdown,
                energy_breakdown=r.energy_breakdown,
                efficiency_fps_per_w=r.efficiency_fps_per_w)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("model", ["alexnet", "vgg19", "resnet50"])
def test_simulate_model_matches_jax_field_for_field(model, bits):
    assert _sim_fields(tsim.simulate_model(model, ab=bits, wb=bits)) == \
        _sim_fields(jsim.simulate_model(model, ab=bits, wb=bits))


def test_peak_gops_and_geometry_sweeps_match_jax():
    from repro.pim import hierarchy as jh
    from repro_torch.pim import hierarchy as th

    for mb, bus in ((16, 64), (64, 128), (256, 256)):
        tg = th.Geometry().with_capacity(mb).with_bus(bus)
        jg = jh.Geometry().with_capacity(mb).with_bus(bus)
        assert tsim.peak_gops(tg) == jsim.peak_gops(jg)
        assert _sim_fields(tsim.simulate_model("alexnet", geometry=tg)) == \
            _sim_fields(jsim.simulate_model("alexnet", geometry=jg))


def test_configs_match_the_reference():
    from repro.configs import paper_cnns as jcfgs

    assert WI_SWEEP == jcfgs.WI_SWEEP
    assert sorted(CONFIGS) == sorted(jcfgs.CONFIGS) == sorted(MODELS)
    for name, c in CONFIGS.items():
        j = jcfgs.CONFIGS[name]
        assert (c.name, c.image, c.classes) == (j.name, j.image, j.classes)
        assert c.pim.tag == j.pim.tag == "<8:8>"
        assert c.pim.backend == "cuda"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, _REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    """The examples run many small ops. With several test processes sharing
    the cores, torch's intra-op threads spend far longer waiting for each
    other than computing, so the examples run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_quickstart_runs_on_cpu(capsys, one_thread):
    r = _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    for backend in ("popcount", "mxu-plane", "int-direct", "cuda"):
        assert f"backend={backend:10s} max rel err" in out
    assert "AlexNet<8:8> logits shape (2, 1000), finite=True" in out
    assert _sim_fields(r) == _sim_fields(jsim.simulate_model("resnet50"))


def test_torch_pim_cnn_inference_runs_on_cpu(capsys, one_thread):
    rows = _example("torch_pim_cnn_inference").main(
        ["--device", "cpu", "--image", "32"])
    out = capsys.readouterr().out
    assert [b for b, *_ in rows] == [2, 4, 8]
    for bits, agree, dmax, r in rows:
        assert 0.0 <= agree <= 1.0 and np.isfinite(dmax)
        assert _sim_fields(r) == _sim_fields(
            jsim.simulate_model("resnet50", ab=bits, wb=bits))
    assert "ResNet50 at 32 px on cpu." in out
