"""Area model (paper Table 3 + Fig. 17).

Cell-array area from a 45 nm NAND-SPIN cell (1T-1MTJ, MTJs over CMOS,
shared heavy-metal strip per 8-MTJ device), divided by the array
efficiency; the in-memory-computing add-on is the paper's measured 8.9%
with the Fig. 17 split.

``CELL_AREA_F2`` and the efficiency curve are chosen so the evaluated
64 MB platform reproduces Table 3's 64.5 mm^2; the efficiency curve's
capacity dependence (periphery amortizes, then long-wire/decoder growth
bites) drives the Fig. 13a per-area trends.
"""
from __future__ import annotations

from .hierarchy import Geometry

FEATURE_M = 45e-9
CELL_AREA_F2 = 15.7          # NAND-SPIN bit cell in F^2 (1T per MTJ + strip share)
ADD_ON_FRACTION = 0.089      # paper: "8.9% area overhead on the memory array"

# Fig. 17 split of the add-on area.
ADD_ON_BREAKDOWN = {
    "compute_units": 0.47,
    "buffer": 0.04,
    "controllers_mux": 0.21,
    "sense_amps_drivers": 0.28,
}


def array_efficiency(capacity_mb: int) -> float:
    """Fraction of die that is cell array. Rises as shared periphery
    amortizes, then falls slowly past 64 MB (wire/decoder growth)."""
    rise = capacity_mb / (capacity_mb + 18.0)
    sag = 1.0 / (1.0 + (capacity_mb / 512.0) ** 1.5)
    return 0.385 * rise * sag


def chip_area_mm2(g: Geometry) -> float:
    cell = CELL_AREA_F2 * FEATURE_M**2
    array_mm2 = g.capacity_bits * cell * 1e6
    die = array_mm2 / array_efficiency(g.capacity_mb)
    return die * (1.0 + ADD_ON_FRACTION)


def add_on_area_mm2(g: Geometry) -> dict:
    total = chip_area_mm2(g) * ADD_ON_FRACTION / (1.0 + ADD_ON_FRACTION)
    return {k: v * total for k, v in ADD_ON_BREAKDOWN.items()}


def ecc_area_mm2(g: Geometry, faults, w_bits: int = 8) -> float:
    """Extra die area of the fault-mitigation hierarchy (DESIGN.md §7).

    Redundant MSB-plane subarrays and spare columns scale the cell array by
    the storage redundancy factor; the majority voter + checksum comparator
    ride the add-on periphery, charged at the sense-amp/driver rate on the
    extra planes (each redundant copy brings its own sense path to vote).
    Zero when ``faults`` is None or carries no mitigation.
    """
    from .cost_model import redundancy_factors

    f = redundancy_factors(faults, w_bits, g.cols)["storage"]
    if f <= 1.0:
        return 0.0
    cell = CELL_AREA_F2 * FEATURE_M**2
    array_mm2 = g.capacity_bits * cell * 1e6
    extra_array = array_mm2 * (f - 1.0)
    extra_periph = (extra_array / array_efficiency(g.capacity_mb)
                    * ADD_ON_FRACTION * ADD_ON_BREAKDOWN["sense_amps_drivers"])
    return extra_array + extra_periph
