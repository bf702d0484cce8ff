"""Architecture-level simulator (the paper's §5.1 in-house simulator).

Walks a CNN layer-spec list and prices every layer's data movement and
in-memory computation. Phases follow Fig. 16:

  load       weight broadcast + buffer fill + initial input programming
  conv       AND/bit-count row-ops + count write-backs + Fig. 9 fold +
             output activation stores
  transfer   in-mat movement of cross-written counts
  pool       comparison / window-addition work
  bn, quant  in-memory affine passes
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.cnn.specs import GemmSpec, model_specs

from .calibrate import Calibration
from .cost_model import Cost, CostModel
from .device import NandSpinDevice, PeripheralCircuits
from .hierarchy import Geometry
from .mapper import OpCounts, map_layer

PHASES = ("load", "conv", "transfer", "pool", "bn", "quant")


@dataclasses.dataclass
class SimResult:
    phases: dict
    latency: float
    energy: float
    fps: float
    geometry: Geometry
    ab: int
    wb: int

    @property
    def latency_breakdown(self) -> dict:
        return {p: c.latency / self.latency for p, c in self.phases.items()}

    @property
    def energy_breakdown(self) -> dict:
        dyn = sum(c.energy for c in self.phases.values())
        return {p: c.energy / dyn for p, c in self.phases.items()}

    @property
    def efficiency_fps_per_w(self) -> float:
        return self.fps / (self.energy * self.fps)  # = 1 / energy-per-frame


def simulate(
    specs: list[GemmSpec],
    geometry: Geometry | None = None,
    ab: int = 8,
    wb: int = 8,
    device: NandSpinDevice | None = None,
    periph: PeripheralCircuits | None = None,
    util: Calibration | None = None,
) -> SimResult:
    g = geometry or Geometry()
    if util is None:
        from .calibrate import calibrated

        util = calibrated()
    cm = CostModel(g, device, periph)
    phases = {p: Cost() for p in PHASES}

    # Initial image enters over the global bus and is programmed into CMs.
    first = next(s for s in specs if s.kind in ("conv", "fc"))
    in_bits = first.in_elems * ab
    iw = OpCounts(program_steps=in_bits // g.cols, erase_ops=in_bits // (g.cols * 8),
                  bus_bits=in_bits, par_bits=in_bits)
    phases["load"] += cm.price_programs(iw)
    phases["load"] += cm.price_bus(iw)

    for spec in specs:
        phase, oc = map_layer(spec, g, ab, wb)
        rowops = cm.price_rowops(oc)
        programs = cm.price_programs(oc)
        bus = cm.price_bus(oc)
        local = cm.price_local(oc)
        # Weight broadcast & buffering belong to the load phase and overlap
        # across layers (double-buffered), but serialize on the shared bus.
        phases["load"] += bus
        phases[phase] += rowops
        phases[phase] += programs
        phases["transfer"] += local

    scaled = {
        p: Cost(c.latency * util.lat[p], c.energy * util.energy[p])
        for p, c in phases.items()
    }
    latency = sum(c.latency for c in scaled.values())
    energy = sum(c.energy for c in scaled.values()) + cm.static_energy(latency)
    return SimResult(phases=scaled, latency=latency, energy=energy,
                     fps=1.0 / latency, geometry=g, ab=ab, wb=wb)


def simulate_model(model: str, batch: int = 1, image: int = 224, **kw) -> SimResult:
    return simulate(model_specs(model, batch=batch, image=image), **kw)


def peak_gops(g: Geometry, cm: CostModel | None = None) -> float:
    """Peak bit-op throughput: every subarray senses one 128-column row per
    AND latency; 2 ops per column (AND + count-accumulate)."""
    cm = cm or CostModel(g)
    return g.n_subarrays * g.cols * 2 / cm.dev.and_latency / 1e9
