"""Training substrate of the port (the JAX package's ``repro.training``).

  optimizer.py        OptimizerConfig, schedule, init_opt_state,
                      global_norm, apply_updates (AdamW, from scratch)
  data.py             DataConfig, SyntheticLM, MemmapTokens, make_source
  train_loop.py       make_loss_fn, make_train_step (QAT through the
                      model's ``train=True``, microbatch accumulation)
  fault_tolerance.py  FTConfig, WatchdogConfig, StragglerDetector,
                      RestartPolicy, run_resilient
  checkpoint.py       atomic, restartable checkpoints of tensor trees
"""
from . import checkpoint
from .data import DataConfig, MemmapTokens, SyntheticLM, make_source
from .fault_tolerance import (FTConfig, RestartPolicy, StragglerDetector,
                              WatchdogConfig, run_resilient)
from .optimizer import OptimizerConfig, apply_updates, init_opt_state
from .train_loop import make_loss_fn, make_train_step

__all__ = ["DataConfig", "FTConfig", "MemmapTokens", "OptimizerConfig",
           "RestartPolicy", "StragglerDetector", "SyntheticLM",
           "WatchdogConfig", "apply_updates", "checkpoint", "init_opt_state",
           "make_loss_fn", "make_source", "make_train_step", "run_resilient"]
