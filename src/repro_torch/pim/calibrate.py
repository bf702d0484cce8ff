"""Calibration of the architecture simulator against the paper's endpoint.

The paper publishes (i) device/circuit constants (§5.1) and (ii) end-to-end
measurements: ResNet50 at 64 MB / 128-bit bus runs at 80.6 FPS (Table 3)
with the Fig. 16 latency/energy phase breakdown. The op-count model in
:mod:`repro_torch.pim.mapper` is mechanistic but cannot capture every scheduling
detail of the in-house simulator (tree-reduction depth in pooling, tag/
result row maintenance in comparisons, the exact replication the mapper
grants each conv layer). Following standard simulator-calibration practice,
we fit one latency and one energy *schedule-efficiency factor per phase* at
the published endpoint and hold them fixed everywhere else.

Everything the benchmarks *sweep* — capacity, bus width, ⟨W:I⟩ precision,
model choice — therefore varies only through the mechanistic op counts;
the calibration is a single fixed point, not a per-experiment fudge.

Factor semantics:
  lat[phase] > 1  -> the real schedule is slower than the op-count lower
                     bound (serialization the mapper does not see)
  lat["conv"] < 1 -> the real schedule is *faster*: the paper replicates
                     input bit-planes across mats so more subarrays can
                     work on one layer than pure residency would allow
"""
from __future__ import annotations

import dataclasses
import functools

# Paper Fig. 16 (ResNet50) phase fractions and Table 3 throughput.
PAPER_FPS_RESNET50 = 80.6
PAPER_LATENCY_FRACTIONS = {
    "load": 0.384, "conv": 0.339, "transfer": 0.048,
    "pool": 0.132, "bn": 0.044, "quant": 0.053,
}
PAPER_ENERGY_FRACTIONS = {
    "load": 0.326, "conv": 0.355, "transfer": 0.049,
    "pool": 0.154, "bn": 0.051, "quant": 0.065,
}


@dataclasses.dataclass(frozen=True)
class Calibration:
    lat: dict
    energy: dict

    @staticmethod
    def identity() -> "Calibration":
        ones = {p: 1.0 for p in PAPER_LATENCY_FRACTIONS}
        return Calibration(lat=dict(ones), energy=dict(ones))


@functools.lru_cache(maxsize=1)
def calibrated() -> Calibration:
    """Fit the per-phase factors at the ResNet50 ⟨8:8⟩ / 64 MB endpoint."""
    from .simulator import simulate_model

    raw = simulate_model("resnet50", util=Calibration.identity())
    total = 1.0 / PAPER_FPS_RESNET50
    lat = {
        p: PAPER_LATENCY_FRACTIONS[p] * total / max(c.latency, 1e-15)
        for p, c in raw.phases.items()
    }
    # Energy: anchor the conv phase at its mechanistic value (its op pricing
    # is the best-grounded: sense energies straight from §5.1) and set the
    # other phases to the published fractions around it.
    conv_e = raw.phases["conv"].energy
    dyn_total = conv_e / PAPER_ENERGY_FRACTIONS["conv"]
    energy = {
        p: PAPER_ENERGY_FRACTIONS[p] * dyn_total / max(c.energy, 1e-15)
        for p, c in raw.phases.items()
    }
    return Calibration(lat=lat, energy=energy)
