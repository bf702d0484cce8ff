"""Carry a parameter tree of the JAX package across to the port.

``params_from_jax(tree)`` takes the JAX package's CNN parameter tree as
nested dicts of numpy arrays (``jax.device_get`` of it) and returns the
same tree of float32 CPU tensors, so both packages compute with the same
weights. This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree):
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))
