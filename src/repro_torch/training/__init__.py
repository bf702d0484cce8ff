"""Training substrate of the port: so far the parts the serving engines'
fault tolerance calls, the step loop and checkpoints
(``ROADMAP.md`` Queue 1, item 5 brings the optimizer and the train loop).

  fault_tolerance.py  FTConfig, WatchdogConfig, StragglerDetector,
                      RestartPolicy, run_resilient
  checkpoint.py       atomic, restartable checkpoints of tensor trees
"""
from . import checkpoint
from .fault_tolerance import (FTConfig, RestartPolicy, StragglerDetector,
                              WatchdogConfig, run_resilient)

__all__ = ["FTConfig", "RestartPolicy", "StragglerDetector",
           "WatchdogConfig", "checkpoint", "run_resilient"]
