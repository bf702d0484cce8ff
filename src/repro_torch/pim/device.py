"""Device/circuit-level constants (paper §5.1, Table 2 and measured results).

The paper's circuit characterization (45 nm PDK + LLG Verilog-A model,
Cadence Spectre/SPICE) reports, for one NAND-SPIN device of 8 MTJs:

  erase   180 fJ / device, ~0.3 ns per MTJ (SOT strip erase, all MTJs at once)
  program 840 fJ / device, 5 ns per bit   (STT AP->P, column-parallel per row)
  read    4.0 fJ / bit,    0.17 ns        (SPCSA sense; AND has the same path)

Counterpart technologies are characterized only as far as the comparison
figures need (baselines.py); their per-bit constants come from the cited
papers' own numbers and are tagged with provenance.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NandSpinDevice:
    mtjs_per_device: int = 8

    erase_energy_per_device: float = 180e-15   # J, resets 8 MTJs
    erase_latency_per_mtj: float = 0.3e-9      # s (paper: "average 0.3 ns each")

    program_energy_per_device: float = 840e-15  # J for all 8 MTJs
    program_latency_per_bit: float = 5e-9       # s, one row-program step

    read_energy_per_bit: float = 4.0e-15        # J
    read_latency: float = 0.17e-9               # s per row operation
    and_energy_per_bit: float = 4.0e-15         # J (same sense path as read)
    and_latency: float = 0.17e-9                # s

    @property
    def erase_latency_per_device(self) -> float:
        return self.erase_latency_per_mtj * self.mtjs_per_device

    @property
    def program_energy_per_bit(self) -> float:
        return self.program_energy_per_device / self.mtjs_per_device


@dataclasses.dataclass(frozen=True)
class PeripheralCircuits:
    """45 nm peripheral constants (bit-counter synthesized with DC, §5.1).

    The paper does not publish the synthesized numbers; these are set to
    representative 45 nm values and participate in the calibration described
    in :mod:`repro_torch.pim.calibrate` (the calibrated model reproduces the
    paper's Fig. 16 breakdown and Table 3 throughput).
    """

    bitcount_energy_per_op: float = 120e-15   # J per 128-bit count-accumulate
    bitcount_latency: float = 0.0             # pipelined behind the AND row op
    buffer_energy_per_bit: float = 10e-15     # J, SRAM weight buffer write/read
    bus_energy_per_bit: float = 2e-12         # J, global bus (NVSim-class 45nm)
    local_bus_energy_per_bit: float = 0.5e-12 # J, in-mat movement
    bus_clock_hz: float = 1.0e9               # 128-bit bus @ 1 GHz
    decoder_energy_per_row_op: float = 30e-15 # J, row/col decode per access
    static_power_per_mb: float = 0.25e-3      # W, controllers/charge pumps etc.
