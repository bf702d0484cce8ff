"""Port parity, the paper's comparison models: the area model (Table 3,
Fig. 17, the fault mitigation's extra area), the analytical counterparts
(DRISA, PRIME, STT-CiM, MRIMA, IMCE; Figs. 14-15), the subarray plan
(Fig. 12), ``PAPER_CLAIMS`` and ``crosscheck_measured``, each equal (``==``)
to the JAX package's: both are host arithmetic on the same numbers. The
averages over the sweep sit within tests/test_pim_simulator.py's
tolerances of the paper's §5.3 claims."""
import dataclasses

import pytest

from repro.core import mapping as jmapping
from repro.models.cnn import specs as jspecs
from repro.pim import area as jarea
from repro.pim import baselines as jbase
from repro.pim import calibrate as jcal
from repro.pim import faults as jfaults
from repro.pim import hierarchy as jh
from repro_torch import core as tcore
from repro_torch import pim as tpim
from repro_torch.models.cnn import specs as tspecs
from repro_torch.pim import area as tarea
from repro_torch.pim import baselines as tbase
from repro_torch.pim import calibrate as tcal
from repro_torch.pim import faults as tfaults
from repro_torch.pim import hierarchy as th

_GEOMETRIES = [(16, 64), (64, 128), (128, 256), (512, 32)]
_FAULTS = [dict(), dict(protect_msb=2), dict(protect_msb=8, vote_copies=5),
           dict(spare_cols=4), dict(protect_msb=3, spare_cols=8)]


@pytest.mark.parametrize("mb,bus", _GEOMETRIES)
def test_area_and_add_on_split_equal_jax(mb, bus):
    tg = th.Geometry().with_capacity(mb).with_bus(bus)
    jg = jh.Geometry().with_capacity(mb).with_bus(bus)
    assert tarea.chip_area_mm2(tg) == jarea.chip_area_mm2(jg)
    assert tarea.add_on_area_mm2(tg) == jarea.add_on_area_mm2(jg)
    assert tarea.array_efficiency(mb) == jarea.array_efficiency(mb)


@pytest.mark.parametrize("kw", _FAULTS, ids=str)
def test_ecc_area_equals_jax(kw):
    """The fault mitigation's extra area through the port's own
    ``cost_model.redundancy_factors``; none without a config."""
    for w_bits in (2, 8):
        tg, jg = th.Geometry(), jh.Geometry()
        assert tarea.ecc_area_mm2(tg, tfaults.FaultConfig(**kw), w_bits) == \
            jarea.ecc_area_mm2(jg, jfaults.FaultConfig(**kw), w_bits)
    assert tarea.ecc_area_mm2(th.Geometry(), None) == 0.0


def test_counterparts_and_their_fits_equal_jax():
    assert [dataclasses.asdict(c) for c in tbase.COUNTERPARTS] == \
        [dataclasses.asdict(c) for c in jbase.COUNTERPARTS]
    assert (tbase.MODELS, tbase.WI_CONFIGS) == (jbase.MODELS,
                                                jbase.WI_CONFIGS)
    for c in tbase.COUNTERPARTS:
        assert tbase._fit(c.name) == jbase._fit(c.name), c.name


def test_speedup_and_energy_tables_equal_jax():
    """Every (model, <W:I>, counterpart) key of both tables, and each
    counterpart's fps and energy per frame, equal the JAX package's."""
    for got, want in ((tbase.speedup_table(), jbase.speedup_table()),
                      (tbase.energy_table(), jbase.energy_table())):
        assert got.keys() == want.keys() and len(got) == 3 * 4 * 5
        for key, value in want.items():
            assert got[key] == value, key
    g = th.Geometry().with_capacity(128)
    assert tbase.speedup_table(g) == jbase.speedup_table(
        jh.Geometry().with_capacity(128))
    for tc, jc in zip(tbase.COUNTERPARTS, jbase.COUNTERPARTS):
        for m in tbase.MODELS:
            for wb, ib in tbase.WI_CONFIGS:
                assert tbase.counterpart_fps(tc, m, wb, ib) == \
                    jbase.counterpart_fps(jc, m, wb, ib)
                assert tbase.counterpart_energy_per_frame(tc, m, wb, ib) == \
                    jbase.counterpart_energy_per_frame(jc, m, wb, ib)


def _avg(table, name):
    vals = [v for (_, _, n), v in table.items() if n == name]
    return sum(vals) / len(vals)


@pytest.mark.parametrize("claim,name,rel", [
    ("speedup_vs_dram", "DRISA", 0.05), ("speedup_vs_stt", "STT-CiM", 0.05),
    ("speedup_vs_sot", "IMCE", 0.35), ("speedup_vs_reram", "PRIME", 0.05)])
def test_average_speedups_within_the_claims(claim, name, rel):
    """The reference test's tolerances (IMCE's Table 3 anchor already sits
    above its claimed average; see tests/test_pim_simulator.py)."""
    avg = _avg(tbase.speedup_table(), name)
    assert avg == pytest.approx(tpim.PAPER_CLAIMS[claim], rel=rel)


@pytest.mark.parametrize("claim,name", [
    ("energy_vs_dram", "DRISA"), ("energy_vs_stt", "STT-CiM"),
    ("energy_vs_reram", "PRIME")])
def test_average_energy_ratios_within_the_claims(claim, name):
    avg = _avg(tbase.energy_table(), name)
    assert avg == pytest.approx(tpim.PAPER_CLAIMS[claim], rel=0.05)


def test_paper_claims_and_area_anchor_equal_jax():
    assert tcal.PAPER_CLAIMS == jcal.PAPER_CLAIMS
    assert tpim.chip_area_mm2(tpim.Geometry()) == pytest.approx(
        tpim.PAPER_CLAIMS["area_mm2"], rel=0.02)


@pytest.mark.parametrize("model", ["alexnet", "vgg19", "resnet50"])
def test_plan_subarrays_at_every_layer_equals_jax(model):
    """Every conv and FC GEMM (M, K, N) of the model at 224 px, batch 1 and
    8, at <2:2>, <4:4>, <8:8> and <8:4>."""
    n = 0
    for batch in (1, 8):
        got_specs = tspecs.model_specs(model, batch=batch, image=224)
        want_specs = jspecs.model_specs(model, batch=batch, image=224)
        for ts, js in zip(got_specs, want_specs):
            if ts.kind not in ("conv", "fc"):
                continue
            for a_bits, w_bits in ((2, 2), (4, 4), (8, 8), (4, 8)):
                got = tcore.plan_subarrays(ts.m, ts.k, ts.n, a_bits, w_bits)
                want = jmapping.plan_subarrays(js.m, js.k, js.n, a_bits,
                                               w_bits)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                n += 1
    assert n > 0
    assert (tcore.mapping.SUBARRAY_ROWS, tcore.mapping.SUBARRAY_COLS) == (
        jmapping.SUBARRAY_ROWS, jmapping.SUBARRAY_COLS)


def test_crosscheck_measured_equals_jax():
    """Measured rows of each kind: quantized cells of the three models at
    224 and 64 px, a float cell (skipped), a model the simulator does not
    know (a null prediction), a row without image or backend."""
    rows = [
        dict(model="resnet50", image=224, precision="<8:8>", img_s=1234.5,
             batch=8, backend="cuda"),
        dict(model="alexnet", image=224, precision="<8:8>", img_s=5678.9,
             backend="popcount"),
        dict(model="vgg19", image=224, precision="<4:4>", img_s=321.0),
        dict(model="alexnet", image=64, precision="<2:2>", img_s=99.0),
        dict(model="resnet50", image=224, precision=None, img_s=3000.0),
        dict(model="mobilenet", image=224, precision="<8:8>", img_s=10.0),
        dict(model="resnet50", precision="<8:8>"),
    ]
    got = tcal.crosscheck_measured(rows)
    assert got == jcal.crosscheck_measured(rows)
    assert len(got) == 6 and got[4]["sim_fps"] is None
