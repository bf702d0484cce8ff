"""Carry a parameter tree of the JAX package across to the port.

``params_from_jax(tree)`` takes a JAX parameter tree as numpy (``jax.
device_get`` of it, or the arrays themselves): the CNN trees and the LM
tree alike, nested dicts and lists with stacked leaves. It returns the same
tree of CPU tensors, so both packages compute with the same weights. Each
leaf goes through numpy as float32 and keeps its type: a bf16 leaf (numpy's
``ml_dtypes`` bfloat16) comes back as ``torch.bfloat16``, which is exact.

``opt_state_from_jax(state)`` does the same for an AdamW state of the JAX
package's ``init_opt_state`` / ``apply_updates`` (``m``, ``v``, ``master``
trees and the int32 ``step``), so both packages can step from one state.
This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree):
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v) for v in tree)
    a = np.asarray(tree)
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t


def opt_state_from_jax(state):
    out = {k: params_from_jax(v) for k, v in state.items() if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32)
    return out
