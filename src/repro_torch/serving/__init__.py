"""Serving engines of the port: the LM engine and the vision engine."""
from .engine import Completion, Request, ServeEngine
from .sampler import SamplerConfig, sample, sample_per_slot
from .vision import (MODEL_ZOO, VisionCompletion, VisionEngine, VisionRequest,
                     parse_precision)

__all__ = ["MODEL_ZOO", "Completion", "Request", "SamplerConfig",
           "ServeEngine", "VisionCompletion", "VisionEngine", "VisionRequest",
           "parse_precision", "sample", "sample_per_slot"]
