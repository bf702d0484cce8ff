"""Batched CNN serving engine: micro-batched vision inference on one GPU.

  * **Queue + power-of-two micro-batching.** Requests carry (image, model,
    precision ``<W:I>``). The engine groups the queue head's (model,
    precision, image-shape) cohort and dispatches the largest power-of-two
    bucket that fits (5 queued -> 4 + 1), so a varied load sees at most
    ``log2(max_batch) + 1`` batch shapes per (model, precision).
  * **Prepack exactly once per (model, precision).** The first request of
    a pair moves the float tree to the device, quantizes and packs every
    conv/fc weight (the paper's program-subarrays-once step) and caches the
    result; every later bucket of that pair reuses it. ``precision=None``
    serves the float forward from the same device-resident masters.
  * **Autotune** (``autotune="cost"|"measure"``,
    :mod:`repro_torch.pim.autotune`). Conv GEMM shapes depend on the image
    size, known only at dispatch, so a quantized bucket dispatches a tuned
    view of the packed tree per (model, precision, image, bucket): the
    same tensors with a decision on every packed weight, kept in
    ``_tuned``. Decisions move dispatch only, so the logits are the
    untuned engine's bit for bit.

Numerics: a bucket's logits equal ``model.apply`` on the same stacked batch
with the same ``PIMQuantConfig`` — activation calibration is per batch in
both, so results depend on bucket composition, as in the JAX package.

Self-healing (``faults``, ``watchdog``; :mod:`repro_torch.pim.faults`):
persistent faults strike each (model, precision) programming pass (the
golden tree is kept for repair); transient read disturb strikes every
quantized dispatch through a per-dispatch key. The watchdog retries a
failed bucket (repairing checksum-flagged columns from the golden tree
first) and degrades a cohort to the float path once its budget is spent;
``degrade_cohort`` / ``restore_cohort`` move a cohort by hand.

The engine runs on ``device`` ("cuda" unless the caller asks otherwise):
on a CUDA device every bit-serial product of the "cuda" and "popcount"
backends goes through the hand-written kernels; ``device="cpu"`` runs their
plain PyTorch versions.
"""
from __future__ import annotations

import collections
import dataclasses
import re
import time
import warnings

import numpy as np
import torch

from repro_torch import disable_tf32
from repro_torch.core import PIMQuantConfig
from repro_torch.models.cnn import MODELS
from repro_torch.models.cnn import layers as L
from repro_torch.pim import faults as _faults
from repro_torch.training.fault_tolerance import RestartPolicy, WatchdogConfig

# The port's CNN zoo, keyed by serving name.
MODEL_ZOO = MODELS

_PRECISION = re.compile(r"^<(\d+):(\d+)>$")


def parse_precision(precision: str | None) -> tuple[int, int] | None:
    """``"<W:I>"`` -> (w_bits, a_bits); None/"float" -> None (fp path)."""
    if precision is None or precision in ("float", "fp32"):
        return None
    m = _PRECISION.match(precision)
    if not m:
        raise ValueError(
            f"precision {precision!r}: want '<W:I>' (e.g. '<8:8>') or None")
    return int(m.group(1)), int(m.group(2))


@dataclasses.dataclass(eq=False)   # identity equality: ndarray fields make
class VisionRequest:               # field-wise __eq__ ambiguous
    rid: int
    image: np.ndarray               # (H, W, C) float
    model: str = "resnet50"
    precision: str | None = "<8:8>"  # "<W:I>" | None (float forward)


@dataclasses.dataclass
class VisionCompletion:
    rid: int
    logits: np.ndarray              # (num_classes,)
    top1: int
    batch: int                      # bucket size this request rode in


# Constructor options of the JAX engines that later slices port, and the
# slice (ROADMAP.md Queue 1) that brings each.
_LATER = {
    "mesh": "mesh serving",
    "pipeline_stages": "pipelined decode with mesh serving",
    "pipeline_microbatches": "pipelined decode with mesh serving",
}


def refuse_unported(engine: str, asked: dict) -> None:
    """Raise ``NotImplementedError`` naming the slice of the first option
    in ``asked`` (name -> set to a non-default) that is set."""
    for name, on in asked.items():
        if on:
            raise NotImplementedError(
                f"{engine}({name}=...) is not ported yet: it comes with "
                f"{_LATER[name]} (ROADMAP.md Queue 1)")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be there if asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch versions "
            "of the kernels")
    return device


class VisionEngine:
    """Micro-batched CNN inference over a model registry.

    ``models`` maps a model name to its float param tree (names resolve
    against the zoo: alexnet, resnet50, vgg19) or to an explicit
    ``(module, params)`` pair for custom CNNs exposing
    ``apply(params, x, cfg=...)``.

    ``backend`` picks the Eq. 1 execution strategy for every quantized
    request (one of ``BACKENDS``: "cuda", "popcount", "mxu-plane",
    "int-direct"); requests pick their own precision. ``max_batch`` is the
    largest micro-batch bucket (rounded down to a power of two).

    ``autotune`` ("off" | "cost" | "measure") tunes every quantized
    bucket's packed weights (conv weights always by cost, as in the
    reference; "measure" times the FC candidates on the device);
    ``tuning_cache`` is a path, a ``TuningCache`` or None (in memory).

    ``faults`` (a :class:`repro_torch.pim.faults.FaultConfig`),
    ``watchdog`` (a :class:`repro_torch.training.fault_tolerance.
    WatchdogConfig`) and ``fault_injector`` (a test hook called with the
    dispatch count, which may raise) arm the self-healing path; ``seed``
    roots the per-dispatch read-disturb keys. A non-default ``mesh``
    raises ``NotImplementedError`` naming the slice that brings it.
    """

    def __init__(self, models: dict, backend: str = "cuda",
                 max_batch: int = 8, mesh=None, faults=None, watchdog=None,
                 fault_injector=None, seed: int = 0, autotune: str = "off",
                 tuning_cache=None, device="cuda"):
        if autotune not in ("off", "cost", "measure"):
            raise ValueError(
                f"autotune {autotune!r}: want 'off' | 'cost' | 'measure'")
        refuse_unported("VisionEngine", dict(mesh=mesh is not None))
        PIMQuantConfig(backend=backend)     # rejects an unknown backend
        self.device = resolve_device(device)
        disable_tf32()
        self._models = {}
        for name, entry in models.items():
            if isinstance(entry, tuple):
                module, params = entry
            else:
                if name not in MODEL_ZOO:
                    raise ValueError(
                        f"unknown model {name!r} (zoo: {sorted(MODEL_ZOO)}); "
                        "pass (module, params) for custom CNNs")
                module, params = MODEL_ZOO[name], entry
            self._models[name] = (module, params)
        self.backend = backend
        self.max_batch = 1 << (max(1, max_batch).bit_length() - 1)
        self.seed = seed
        self.autotune = autotune
        self._tuning_cache_arg = tuning_cache
        self.tune_cache = None
        self._tuned: dict = {}      # (model, precision, h, w, bucket) -> tree
        self.queue: collections.deque = collections.deque()
        self._masters: dict = {}    # model -> float tree on the device
        self._packed: dict = {}     # (model, precision) -> param tree
        self._golden: dict = {}     # (model, precision) -> fault-free tree
        self.prepacks = 0           # (model, precision) trees built
        # Self-healing: the watchdog retries failed buckets (repairing
        # flagged columns from the golden tree when the checksum is armed)
        # and degrades a cohort to the float path once its budget is spent.
        self.faults = faults
        self.watchdog = watchdog
        self.fault_injector = fault_injector   # test hook: raises per dispatch
        self._wd = wd = watchdog or WatchdogConfig()
        self._policy = RestartPolicy(wd.max_failures, wd.backoff_s)
        self._degraded: set = set()            # (model, precision) cohorts
        # The reference's fault key, PRNGKey(seed) split once a quantized
        # dispatch under transient faults: kept as its chain length.
        self._fault_chain = 0
        self.health = {"dispatches": 0, "rollbacks": 0, "repairs": 0,
                       "repaired_cols": 0, "degraded": []}

    def _cfg(self, precision: str | None) -> PIMQuantConfig | None:
        bits = parse_precision(precision)
        if bits is None:
            return None
        return PIMQuantConfig(w_bits=bits[0], a_bits=bits[1],
                              backend=self.backend)

    def _packed_params(self, model: str, precision: str | None):
        """Move to the device and quantize+pack exactly once per pair.

        With persistent faults the freshly programmed tree is corrupted
        (each (model, precision) pair with its own key fold,
        ``fold_in(faults.key(), len(golden))``), and the fault-free tree is
        kept as the golden master the checksum repair re-programs from."""
        mkey = (model, precision)
        tree = self._packed.get(mkey)
        if tree is None:
            masters = self._masters.get(model)
            if masters is None:
                masters = L.tree_to(self._models[model][1], self.device)
                self._masters[model] = masters
            cfg = self._cfg(precision)
            tree = L.prepack_params(masters, cfg) if cfg is not None \
                else masters
            if cfg is not None and self.faults is not None \
                    and self.faults.persistent:
                self._golden[mkey] = tree
                key = self.faults.key().fold_in(len(self._golden))
                tree, _ = _faults.inject_tree(tree, self.faults, key)
            self._packed[mkey] = tree
            self.prepacks += 1
        return tree

    def _repair(self, model: str, precision: str | None) -> int:
        """Checksum-scan the cohort's packed tree and re-program flagged
        columns from the golden master (bounded by the spare budget).
        Returns the number of repaired columns."""
        mkey = (model, precision)
        golden = self._golden.get(mkey)
        if golden is None or self.faults is None or not self.faults.checksum:
            return 0
        tree, report = _faults.repair_tree(self._packed[mkey], golden,
                                           self.faults.spare_cols,
                                           self.faults.subarray_cols)
        self._packed[mkey] = tree
        # Tuned views hold the pre-repair tensors; drop them so the next
        # dispatch re-derives from the repaired tree (the decisions come
        # back from the tuning cache).
        self._tuned = {k: v for k, v in self._tuned.items()
                       if k[:2] != mkey}
        return report["repaired_cols"]

    def _tuned_params(self, model: str, precision: str, shape):
        """Tuned view of the packed tree for one (cohort, image, bucket).

        Decisions are per GEMM: FC weights tune on the bucket's row count,
        conv weights on the im2col row bound ``batch * H * W`` (the
        stride-1 upper bound; the backend crossover is driven by the
        plane-pair count, which the bound preserves). Attaching a decision
        makes a new packed weight over the same tensors: no copy.
        """
        n, h, w, _ = shape
        tkey = (model, precision, h, w, n)
        tree = self._tuned.get(tkey)
        if tree is None:
            from repro_torch.pim import autotune as _at

            if self.tune_cache is None:
                self.tune_cache = _at.as_cache(self._tuning_cache_arg)
            tree = _at.tune_tree(
                self._packed[(model, precision)], m_hint=n,
                a_bits=parse_precision(precision)[1],
                backends=_at.default_backends(self.device),
                mode=self.autotune, cache=self.tune_cache,
                conv_m_hint=n * h * w, device=self.device)
            self._tuned[tkey] = tree
        return tree

    def close(self):
        """Engine teardown: reset the tuning cache, so a later engine
        sharing the cache object re-reads its (possibly repaired) backing
        file instead of serving this engine's stale fallback memo."""
        if self.tune_cache is not None:
            self.tune_cache.reset()

    # -- public API ----------------------------------------------------------

    def submit(self, req: VisionRequest):
        if req.model not in self._models:
            raise ValueError(f"unknown model {req.model!r} "
                             f"(registered: {sorted(self._models)})")
        # Validate at admission and canonicalize the float spellings so
        # "float"/"fp32"/None requests share one cohort.
        if parse_precision(req.precision) is None:
            req.precision = None
        self.queue.append(req)

    def cancel(self, rid: int) -> bool:
        """Remove a queued request; False if no queued request has ``rid``.
        A bucket in flight has no state to release, so this is queue
        surgery only."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                return True
        return False

    @property
    def n_free_slots(self) -> int:
        """Admission headroom: the engine buckets at most ``max_batch`` a
        step, so at most one bucket's worth waits in the queue."""
        return max(0, self.max_batch - len(self.queue))

    def degrade_cohort(self, model: str, precision: str | None) -> bool:
        """Move a (model, precision) cohort to the float path (the
        watchdog's budget-spent action, exposed as a lever). Returns True
        if newly degraded."""
        mkey = (model, precision)
        if precision is None or mkey in self._degraded:
            return False
        self._degraded.add(mkey)
        self.health["degraded"].append(mkey)
        return True

    def restore_cohort(self, model: str, precision: str | None) -> bool:
        """Reverse :meth:`degrade_cohort` (the health log keeps the
        history). Returns True if the cohort was degraded."""
        mkey = (model, precision)
        if mkey not in self._degraded:
            return False
        self._degraded.discard(mkey)
        return True

    @property
    def _transient(self) -> bool:
        return self.faults is not None and self.faults.transient

    def _group_key(self, req: VisionRequest):
        return (req.model, req.precision, np.asarray(req.image).shape)

    def step(self) -> list:
        """Dispatch one micro-batch bucket; returns its completions.

        The queue head picks the (model, precision, shape) cohort; the
        bucket is the largest power of two <= min(cohort, max_batch).
        """
        if not self.queue:
            return []
        key = self._group_key(self.queue[0])
        m = 0
        for r in self.queue:
            if self._group_key(r) == key:
                m += 1
                if m == self.max_batch:
                    break
        bucket = 1 << (m.bit_length() - 1)
        group, kept = [], []
        for r in self.queue:
            if len(group) < bucket and self._group_key(r) == key:
                group.append(r)
            else:
                kept.append(r)
        self.queue = collections.deque(kept)
        model, precision, _ = key
        if (model, precision) in self._degraded:
            # Degraded cohort: the float path (completions keep their rids).
            precision = None
        if self.watchdog is None and self.fault_injector is None:
            return self._dispatch(group, model, precision)
        return self._dispatch_supervised(group, model, precision)

    def _dispatch(self, group, model: str, precision: str | None) -> list:
        bucket = len(group)
        batch = torch.from_numpy(
            np.stack([np.asarray(r.image, np.float32) for r in group])
        ).to(self.device)
        params = self._packed_params(model, precision)
        if precision is not None and self.autotune != "off":
            params = self._tuned_params(model, precision, batch.shape)
        module, _ = self._models[model]
        with torch.inference_mode():
            if precision is not None and self._transient:
                # fault_key, dkey = split(fault_key): every bit-serial
                # weight read of the bucket draws from dkey's sites.
                dkey = _faults.Key.root(self.seed).chain(
                    self._fault_chain).split(2, 1)
                self._fault_chain += 1
                with _faults.read_disturb_scope(self.faults, dkey):
                    logits = module.apply(params, batch,
                                          cfg=self._cfg(precision))
            else:
                logits = module.apply(params, batch, cfg=self._cfg(precision))
        logits = logits.cpu().numpy()
        return [
            VisionCompletion(rid=r.rid, logits=logits[i],
                             top1=int(logits[i].argmax()), batch=bucket)
            for i, r in enumerate(group)
        ]

    def _dispatch_supervised(self, group, model: str,
                             precision: str | None) -> list:
        """Supervised bucket dispatch: retry under backoff on an injected
        fault, a device runtime error, non-finite logits or a blown
        deadline, repairing checksum-flagged columns before each retry;
        once the failure budget is spent, degrade the cohort to the float
        path and serve the bucket there. The group is held here (already
        split off the queue), so a retry is a pure re-dispatch."""
        wd = self._wd
        while True:
            try:
                t0 = time.monotonic()
                if self.fault_injector is not None:
                    self.fault_injector(self.health["dispatches"])
                out = self._dispatch(group, model, precision)
                dt = time.monotonic() - t0
                if wd.deadline_s is not None and dt > wd.deadline_s:
                    raise RuntimeError(
                        "vision dispatch exceeded deadline "
                        f"({dt:.3f}s > {wd.deadline_s:.3f}s)")
                if any(not np.isfinite(c.logits).all() for c in out):
                    raise RuntimeError("non-finite logits in vision dispatch")
                self.health["dispatches"] += 1
                self._policy.record_progress(self.health["dispatches"])
                return out
            except RuntimeError as e:
                self.health["rollbacks"] += 1
                try:
                    wait = self._policy.on_failure()
                except RuntimeError:
                    # Budget spent. The float path failing, or degrade
                    # off: surface the error.
                    if precision is None or not wd.degrade:
                        raise
                    mkey = (model, precision)
                    self._degraded.add(mkey)
                    self.health["degraded"].append(mkey)
                    self._policy = RestartPolicy(wd.max_failures, wd.backoff_s)
                    print(f"[vision-watchdog] cohort {mkey} degraded to the "
                          f"float path after {wd.max_failures} failures",
                          flush=True)
                    return self._dispatch(group, model, None)
                fixed = self._repair(model, precision)
                if fixed:
                    self.health["repairs"] += 1
                    self.health["repaired_cols"] += fixed
                print(f"[vision-watchdog] dispatch failed ({e!r}); "
                      f"repaired {fixed} col(s), retrying in {wait:.3f}s",
                      flush=True)
                time.sleep(min(wait, 0.05))  # bounded for tests

    def run(self, max_steps: int = 10_000, strict: bool = False) -> list:
        """Drain the queue; returns all completions.

        If the step budget runs out with requests still queued, raise
        (``strict=True``) or emit a ``RuntimeWarning`` naming the stranded
        rids.
        """
        out = []
        for _ in range(max_steps):
            if not self.queue:
                return out
            out.extend(self.step())
        if self.queue:
            rids = [r.rid for r in self.queue]
            msg = (f"VisionEngine.run: {len(rids)} request(s) still queued "
                   f"after {max_steps} steps (rids {rids[:8]})")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning)
        return out
