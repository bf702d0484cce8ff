"""Prices the mapper's operation counts in seconds and joules.

Latency: row-ops and program bursts run in parallel across the subarrays
that physically hold the layer's data (residency-limited width
``P = ceil(par_bits / subarray_bits)``, optionally boosted by the
replication factor when spare capacity allows duplicating operands — the
paper avoids duplication, so the default replication is 1).

Energy: per-op pricing from :mod:`repro_torch.pim.device` plus static power
integrated over the runtime.

Fault mitigation (:mod:`repro_torch.pim.faults`) is charged here too:
replicated MSB planes multiply storage, sense work and programming; spare
columns multiply storage and programming. Pass a ``FaultConfig`` to
:class:`CostModel` and the per-phase prices scale by
:func:`redundancy_factors`; None keeps every price bit-identical to the
unprotected model.
"""
from __future__ import annotations

import dataclasses
import math

from .device import NandSpinDevice, PeripheralCircuits
from .hierarchy import Geometry
from .mapper import OpCounts


def redundancy_factors(faults, w_bits: int, cols: int) -> dict:
    """Multiplicative overheads of the mitigation hierarchy.

    ``storage`` — stored bit-planes + spare columns vs. bare: the top
    ``protect_msb`` of ``w_bits`` planes each occupy ``vote_copies``
    subarrays, and ``spare_cols`` standby columns ride every subarray row.
    ``rowops``  — extra sense-path work: a protected plane is sensed once
    per stored copy, then majority-voted in the periphery.
    ``program`` — every redundant plane (and spare) programs its own cells.

    The column-sum checksum is free in storage: ``col_sums`` already exists
    as the affine correction's Sw register.
    """
    if faults is None:
        return {"storage": 1.0, "rowops": 1.0, "program": 1.0}
    p = min(faults.protect_msb, w_bits) / float(w_bits)
    red = 1.0 + p * (faults.vote_copies - 1)
    spares = faults.spare_cols / float(cols) if cols else 0.0
    return {"storage": red + spares, "rowops": red, "program": red + spares}


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
        faults=None,                 # FaultConfig: charge its mitigation
        w_bits: int = 8,
    ):
        self.g = geometry
        self.dev = device or NandSpinDevice()
        self.per = periph or PeripheralCircuits()
        self.red = redundancy_factors(faults, w_bits, geometry.cols)

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
        """Sense-path work: AND + bit-count + reads (x redundant copies)."""
        p = self.parallel_width(oc)
        f = self.red["rowops"]
        rowops = (oc.and_rowops + oc.read_rowops) * f
        lat = max(rowops / p, float(oc.seq_floor)) * self.dev.and_latency
        e = f * (oc.and_rowops * self.e_and_rowop
                 + oc.read_rowops * self.e_read_rowop)
        return Cost(lat, e)

    def price_programs(self, oc: OpCounts) -> Cost:
        """STT program bursts + SOT erases issued by this layer
        (x redundant planes + spares)."""
        p = self.parallel_width(oc)
        f = self.red["program"]
        lat = f * (oc.program_steps * self.dev.program_latency_per_bit
                   + oc.erase_ops * self.dev.erase_latency_per_device) / p
        e = f * (oc.program_steps * self.e_program_step
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
