"""Device -> architecture evaluation substrate (paper §5), pure host
arithmetic copied from the JAX package's ``pim`` for pricing the port's
CNNs on the NAND-SPIN architecture.

  device.py      NAND-SPIN + peripheral circuit constants (§5.1)
  hierarchy.py   subarray/mat/bank organization (§5.2)
  mapper.py      layer -> micro-operation counts (the §4 mapping scheme)
  cost_model.py  op pricing in seconds/joules
  calibrate.py   per-phase schedule-efficiency fit at the published endpoint
  simulator.py   end-to-end CNN inference latency/energy/FPS
"""
from .calibrate import Calibration, calibrated
from .cost_model import Cost, CostModel
from .device import NandSpinDevice, PeripheralCircuits
from .hierarchy import Geometry
from .simulator import SimResult, peak_gops, simulate, simulate_model

__all__ = [
    "Calibration", "calibrated", "Cost", "CostModel", "NandSpinDevice",
    "PeripheralCircuits", "Geometry", "SimResult", "peak_gops", "simulate",
    "simulate_model",
]
