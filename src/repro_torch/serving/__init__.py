"""Serving engines of the port (the vision engine so far)."""
from .vision import (MODEL_ZOO, VisionCompletion, VisionEngine, VisionRequest,
                     parse_precision)

__all__ = ["MODEL_ZOO", "VisionCompletion", "VisionEngine", "VisionRequest",
           "parse_precision"]
