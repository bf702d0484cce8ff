"""Prices the mapper's operation counts in seconds and joules.

Latency: row-ops and program bursts run in parallel across the subarrays
that physically hold the layer's data (residency-limited width
``P = ceil(par_bits / subarray_bits)``, optionally boosted by the
replication factor when spare capacity allows duplicating operands — the
paper avoids duplication, so the default replication is 1).

Energy: per-op pricing from :mod:`repro_torch.pim.device` plus static power
integrated over the runtime.

The JAX package's cost model also charges the fault mitigation of its
``pim.faults`` (factors that are exactly 1 without it); the port has no
fault model, so its prices are those of the unprotected model.
"""
from __future__ import annotations

import dataclasses
import math

from .device import NandSpinDevice, PeripheralCircuits
from .hierarchy import Geometry
from .mapper import OpCounts


@dataclasses.dataclass
class Cost:
    latency: float = 0.0
    energy: float = 0.0

    def __iadd__(self, o: "Cost") -> "Cost":
        self.latency += o.latency
        self.energy += o.energy
        return self


class CostModel:
    def __init__(
        self,
        geometry: Geometry,
        device: NandSpinDevice | None = None,
        periph: PeripheralCircuits | None = None,
    ):
        self.g = geometry
        self.dev = device or NandSpinDevice()
        self.per = periph or PeripheralCircuits()

    # -- widths -------------------------------------------------------------

    def parallel_width(self, oc: OpCounts) -> float:
        p = math.ceil(oc.par_bits / self.g.subarray_bits)
        return float(min(max(p, 1), self.g.n_subarrays))

    # -- primitive prices ----------------------------------------------------

    @property
    def e_and_rowop(self) -> float:
        return (self.g.cols * self.dev.and_energy_per_bit
                + self.per.bitcount_energy_per_op
                + self.per.decoder_energy_per_row_op)

    @property
    def e_read_rowop(self) -> float:
        return self.g.cols * self.dev.read_energy_per_bit + self.per.decoder_energy_per_row_op

    @property
    def e_program_step(self) -> float:
        # one row-program: up to 128 column-parallel STT switches
        return self.g.cols * self.dev.program_energy_per_bit

    @property
    def e_erase(self) -> float:
        return self.g.cols * self.dev.erase_energy_per_device

    def bus_time(self, bits: int) -> float:
        return bits / (self.g.bus_bits * self.per.bus_clock_hz)

    # -- phase pricing ---------------------------------------------------

    def price_rowops(self, oc: OpCounts) -> Cost:
        """Sense-path work: AND + bit-count + reads."""
        p = self.parallel_width(oc)
        rowops = oc.and_rowops + oc.read_rowops
        lat = max(rowops / p, float(oc.seq_floor)) * self.dev.and_latency
        e = (oc.and_rowops * self.e_and_rowop
             + oc.read_rowops * self.e_read_rowop)
        return Cost(lat, e)

    def price_programs(self, oc: OpCounts) -> Cost:
        """STT program bursts + SOT erases issued by this layer."""
        p = self.parallel_width(oc)
        lat = (oc.program_steps * self.dev.program_latency_per_bit
               + oc.erase_ops * self.dev.erase_latency_per_device) / p
        e = (oc.program_steps * self.e_program_step
             + oc.erase_ops * self.e_erase)
        return Cost(lat, e)

    def price_bus(self, oc: OpCounts) -> Cost:
        lat = self.bus_time(oc.bus_bits)
        e = (oc.bus_bits * self.per.bus_energy_per_bit
             + oc.buffer_bits * self.per.buffer_energy_per_bit)
        return Cost(lat, e)

    def price_local(self, oc: OpCounts) -> Cost:
        # In-mat movement rides private ports (§3.2), one per mat in parallel.
        lat = oc.local_bits / (self.g.bus_bits * self.per.bus_clock_hz * self.g.n_mats)
        return Cost(lat, oc.local_bits * self.per.local_bus_energy_per_bit)

    def static_energy(self, latency: float) -> float:
        return latency * self.per.static_power_per_mb * self.g.capacity_mb
