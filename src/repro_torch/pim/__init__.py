"""Device -> architecture evaluation substrate (paper §5), pure host
arithmetic copied from the JAX package's ``pim`` for pricing the port's
CNNs on the NAND-SPIN architecture.

  device.py      NAND-SPIN + peripheral circuit constants (§5.1)
  hierarchy.py   subarray/mat/bank organization (§5.2)
  mapper.py      layer -> micro-operation counts (the §4 mapping scheme)
  cost_model.py  op pricing in seconds/joules
  calibrate.py   per-phase schedule-efficiency fit at the published endpoint
  simulator.py   end-to-end CNN inference latency/energy/FPS
  faults.py      STT-MRAM fault model + ECC-style mitigation
  autotune.py    per-weight backend and tile decisions
"""
from .calibrate import Calibration, calibrated
from .cost_model import Cost, CostModel, redundancy_factors
from .device import NandSpinDevice, PeripheralCircuits
from .faults import (FaultConfig, disturb_packed, inject_packed, inject_tree,
                     read_disturb_scope, repair_packed, repair_tree,
                     verify_columns)
from .hierarchy import Geometry
from .simulator import SimResult, peak_gops, simulate, simulate_model

__all__ = [
    "Calibration", "calibrated", "Cost", "CostModel", "redundancy_factors",
    "NandSpinDevice", "PeripheralCircuits", "FaultConfig", "disturb_packed",
    "inject_packed", "inject_tree", "read_disturb_scope", "repair_packed",
    "repair_tree", "verify_columns", "Geometry", "SimResult", "peak_gops",
    "simulate", "simulate_model",
]
