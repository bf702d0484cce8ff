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
# Headline comparison claims used by the validation tests.
PAPER_CLAIMS = {
    "speedup_vs_dram": 6.3, "speedup_vs_stt": 2.6,
    "speedup_vs_reram": 13.5, "speedup_vs_sot": 5.1,
    "energy_vs_dram": 2.3, "energy_vs_stt": 1.4,
    "energy_vs_reram": 12.3, "energy_vs_sot": 2.6,
    "throughput_fps": 80.6, "area_mm2": 64.5,
}


@dataclasses.dataclass(frozen=True)
class Calibration:
    lat: dict
    energy: dict

    @staticmethod
    def identity() -> "Calibration":
        ones = {p: 1.0 for p in PAPER_LATENCY_FRACTIONS}
        return Calibration(lat=dict(ones), energy=dict(ones))


def crosscheck_measured(rows: list) -> list:
    """Cross-check measured vision-engine throughput against the simulator.

    ``rows`` are measured serving cells (model / image / precision
    ``<W:I>`` / img_s, optionally batch and backend). For each quantized
    cell of a simulator-known model, price the same (model, image, ⟨W:I⟩)
    on the calibrated NAND-SPIN architecture and report the
    measured-to-simulated fps ratio.

    The two numbers answer different questions — the engine measures the
    GPU *reproduction* of the dataflow, the simulator prices the paper's
    *hardware* — so the ratio is a tracked trajectory, not an agreement
    check: a sudden shift flags either a serving-path perf regression or a
    simulator/calibration change.
    """
    import re

    from .simulator import simulate_model

    out = []
    for r in rows:
        m = re.match(r"^<(\d+):(\d+)>$", str(r.get("precision", "")))
        if not m:
            continue                      # float reference cells: nothing to price
        wb, ab = int(m.group(1)), int(m.group(2))
        try:
            sim = simulate_model(r["model"], image=int(r.get("image", 224)),
                                 ab=ab, wb=wb)
            fps = round(sim.fps, 2)
        except KeyError:
            # A model outside the simulator's registry (models/cnn/specs.py)
            # keeps its row with a null prediction, so the gap is visible.
            fps = None
        measured = float(r.get("img_s", 0.0))
        out.append({
            "model": r["model"], "image": r.get("image", 224),
            "W:I": f"<{wb}:{ab}>", "batch": r.get("batch", 1),
            # The Eq. 1 backend the measured cell ran: a measured/sim shift
            # is only attributable if the row says which strategy moved.
            "backend": r.get("backend", "unknown"),
            "measured_img_s": round(measured, 2),
            "sim_fps": fps,
            "measured/sim": round(measured / fps, 4) if fps else None,
        })
    return out


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
