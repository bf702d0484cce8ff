"""Configurations of the port (the paper's CNN benchmarks so far)."""
from .paper_cnns import CONFIGS, WI_SWEEP, CNNBenchConfig

__all__ = ["CONFIGS", "WI_SWEEP", "CNNBenchConfig"]
