"""Telemetry of the serving front door: the ``Ring`` buffer.

A copy of the JAX package's ``Ring`` (``repro.serving.gateway``); the
engines' ``stats()`` channels are built on it. The rest of the gateway
(admission, deadlines, shedding, degradation) comes in a later slice
(``ROADMAP.md`` Queue 1, item 6).
"""
from __future__ import annotations

import numpy as np


class Ring:
    """Fixed-size float ring buffer with percentile snapshots.

    The telemetry backbone: O(1) push, O(size) snapshot, constant memory —
    a long-running gateway never grows its metrics state.
    """

    def __init__(self, size: int = 512):
        self._buf = np.zeros(size, np.float64)
        self._n = 0            # total pushes (monotonic)
        self._size = size

    def push(self, v: float):
        self._buf[self._n % self._size] = v
        self._n += 1

    def __len__(self):
        return min(self._n, self._size)

    def values(self) -> np.ndarray:
        return self._buf[:len(self)].copy()

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        if not len(self):
            return {f"p{q}": None for q in qs}
        v = self.values()
        return {f"p{q}": float(np.percentile(v, q)) for q in qs}


__all__ = ["Ring"]
