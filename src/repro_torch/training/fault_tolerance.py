"""Fault tolerance: a preemption-safe step loop, straggler detection and
a bounded restart policy (the JAX package's ``training.fault_tolerance``).

  1. *Checkpoint/restart*: :func:`run_resilient` wraps a step loop with
     periodic async checkpoints (:mod:`.checkpoint`); a step keyed by its
     index restarts bit for bit from ``LATEST``.
  2. *Failure detection and retry*: a step that raises a runtime error
     (a CUDA error, ``torch.OutOfMemoryError``, an injected fault: each a
     ``RuntimeError``) rolls back to ``LATEST`` and runs again after a
     bounded exponential backoff; past ``max_failures`` the error is
     raised.
  3. *Straggler mitigation*: step wall times feed an online median/MAD
     estimator (:class:`StragglerDetector`); slow steps are counted and
     handed to a callback.

:class:`WatchdogConfig` configures the serving engines' per-dispatch
supervision, which uses the same :class:`RestartPolicy` and detector.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import os
import tempfile
import time

import torch

from . import checkpoint as ckpt


@dataclasses.dataclass
class FTConfig:
    # The reference's /tmp/repro_ckpt, under this process's temp directory.
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    max_failures: int = 3
    backoff_s: float = 1.0
    straggler_z: float = 4.0
    keep_last: int = 3


@dataclasses.dataclass
class WatchdogConfig:
    """Per-dispatch supervision of a serving engine.

    The engine's ``step()`` becomes a supervised dispatch: an in-memory
    shadow of the engine is taken before each dispatch; a failure (an
    injected fault, a device runtime error, non-finite logits, or a
    dispatch slower than ``deadline_s``) rolls back to the shadow and
    retries under :class:`RestartPolicy` backoff. Once the failure budget
    is spent, ``degrade=True`` drops the engine to the float path and keeps
    serving. ``snap_every``/``ckpt_dir`` also write a disk snapshot every
    N successful dispatches.
    """

    deadline_s: float | None = None
    max_failures: int = 3
    backoff_s: float = 0.05
    degrade: bool = True
    snap_every: int = 0
    ckpt_dir: str | None = None
    straggler_z: float = 4.0


class StragglerDetector:
    """Online robust z-score over step times (median/MAD over a window).

    The window is a ``deque`` with an order-maintained mirror: the median
    is O(1), each observation one ``insort`` and one eviction, and the MAD
    a two-pointer merge of the sorted runs around the median.
    """

    def __init__(self, z_thresh: float = 4.0, window: int = 128):
        self.z = z_thresh
        self.window = window
        self.times: collections.deque = collections.deque()
        self._sorted: list = []
        self.flagged = 0

    @staticmethod
    def _mad(s: list, med: float) -> float:
        # (len//2)-th smallest |t - med|: the deviations of the sorted
        # window form two sorted runs, merged from the median outwards.
        k = len(s) // 2
        lo = bisect.bisect_left(s, med) - 1
        hi = lo + 1
        dev = 0.0
        for _ in range(k + 1):
            left = med - s[lo] if lo >= 0 else math.inf
            right = s[hi] - med if hi < len(s) else math.inf
            if left <= right:
                dev, lo = left, lo - 1
            else:
                dev, hi = right, hi + 1
        return dev

    def observe(self, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 16:
            s = self._sorted
            med = s[len(s) // 2]
            # sigma floor at 5% of the median: a uniform history (MAD ~ 0)
            # must not flag ordinary jitter.
            sigma = max(1.4826 * self._mad(s, med), 0.05 * med, 1e-9)
            is_straggler = (dt - med) / sigma > self.z
            if is_straggler:
                self.flagged += 1
        self.times.append(dt)
        bisect.insort(self._sorted, dt)
        if len(self.times) > self.window:
            old = self.times.popleft()
            del self._sorted[bisect.bisect_left(self._sorted, old)]
        return is_straggler


class RestartPolicy:
    """Bounded exponential backoff; resets after sustained progress."""

    def __init__(self, max_failures: int, backoff_s: float):
        self.max_failures = max_failures
        self.backoff_s = backoff_s
        self.failures = 0
        self.last_good_step = -1

    def record_progress(self, step: int):
        if step - self.last_good_step >= 50:
            self.failures = 0
            self.last_good_step = step

    def on_failure(self) -> float:
        """Returns backoff seconds; raises if the budget is exhausted."""
        self.failures += 1
        if self.failures > self.max_failures:
            raise RuntimeError(
                f"exceeded {self.max_failures} failures without progress")
        return self.backoff_s * (2 ** (self.failures - 1))


def _wait(metrics) -> None:
    """Block until the step's loss exists: ``.item()`` of a tensor (a
    device-to-host read), a synchronise of the card otherwise."""
    loss = metrics.get("loss") if isinstance(metrics, dict) else None
    if isinstance(loss, torch.Tensor):
        loss.item()
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def run_resilient(
    step_fn,                 # (params, opt_state, batch) -> (params, opt, metrics)
    params,
    opt_state,
    data_source,             # .batch(step) -> host batch dict
    n_steps: int,
    cfg: FTConfig,
    put_batch=None,          # host batch -> device tensors
    on_straggler=None,       # callback(step, dt)
    on_metrics=None,         # callback(step, metrics)
    fail_injector=None,      # test hook: raises inside the loop
):
    """The resilient step loop. Returns (params, opt_state, stats).

    ``params`` and ``opt_state`` are trees of tensors (dicts, lists,
    tuples); a restore loads the last checkpoint into trees like them, on
    their devices."""
    detector = StragglerDetector(cfg.straggler_z)
    policy = RestartPolicy(cfg.max_failures, cfg.backoff_s)
    put = put_batch or (lambda b: b)

    start = ckpt.latest_step(cfg.ckpt_dir)
    if start is not None:
        (params, opt_state), m = ckpt.restore(cfg.ckpt_dir, (params, opt_state))
        step = m["step"] + 1
    else:
        step = 0

    stats = {"restarts": 0, "stragglers": 0, "steps_run": 0}
    while step < n_steps:
        try:
            # Monotonic: straggler accounting must not see a wall-clock
            # step as a multi-second stall (or a negative time).
            t0 = time.monotonic()
            if fail_injector is not None:
                fail_injector(step)
            batch = put(data_source.batch(step))
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            _wait(metrics)
            dt = time.monotonic() - t0
            if detector.observe(dt):
                stats["stragglers"] += 1
                if on_straggler:
                    on_straggler(step, dt)
            if on_metrics:
                on_metrics(step, metrics)
            if step % cfg.ckpt_every == 0 and step > 0:
                ckpt.save_async(cfg.ckpt_dir, step, (params, opt_state))
            policy.record_progress(step)
            stats["steps_run"] += 1
            step += 1
        except RuntimeError as e:
            print(f"[fault-tolerance] step {step} failed: {e!r}", flush=True)
            wait = policy.on_failure()
            stats["restarts"] += 1
            time.sleep(min(wait, 0.05))  # bounded for tests; real: full wait
            ckpt.wait_pending()
            last = ckpt.latest_step(cfg.ckpt_dir)
            if last is not None:
                (params, opt_state), m = ckpt.restore(cfg.ckpt_dir,
                                                      (params, opt_state))
                step = m["step"] + 1
            else:
                step = 0
    ckpt.wait_pending()
    ckpt.save(cfg.ckpt_dir, n_steps - 1, (params, opt_state))
    return params, opt_state, stats
