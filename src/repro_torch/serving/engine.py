"""Batched LM serving engine: continuous batching over a fixed decode grid,
on one device.

The engine owns one decode state of shape (max_batch, ...) on the device
plus a per-slot control block there (last token, eos id, remaining budget,
live flag), and runs two paths:

  * **Admission.** The prompt is split into its binary decomposition of
    power-of-two chunks (13 -> 8 + 4 + 1) and each chunk prefills into
    slot ``i`` through ``prefill_into_slot``. Chunking (instead of
    right-padding to a bucket) keeps recurrent states exact: the carry
    threads across chunks and no pad token enters the recurrence. On an
    ``rwkv`` model every chunk of 16 or more tokens runs the chunked WKV
    kernel; on a dense model a chunk at an offset above 0 attends over the
    KV rows the earlier chunks wrote; on the hybrid (``rglru`` and
    ``local_attn``) a chunk scans the RG-LRU from the carried state (a
    one-token chunk takes the decode step) and attends over the ring
    buffer as it was before the chunk plus its own tokens. The first token
    is sampled on the device and read once.
  * **``decode_n``.** Up to ``drain_steps`` fused decode + sample steps per
    dispatch when no admissions are pending. The control block stays on
    the device; only the (n, B) sampled tokens and done flags cross to the
    host, in one copy per dispatch, never the (B, vocab) logits (an MoE
    engine adds one more: the (n,) per-step dropped-assignment fractions,
    which feed the ``moe_drop_frac`` ring of ``stats()``). Dead slots
    decode into their frozen position (a KV write lands on one row, which
    the next occupant overwrites before it can attend to it; recurrent
    carries and ring rows, which are position-less, are zeroed by the next
    occupant's first chunk); the grid never reshapes.

Continuous batching: when a sequence finishes (EOS or budget), its slot is
released and the next queued request prefills into it. While the queue is
non-empty the engine decodes one step at a time so a freed slot is
refilled at the next token boundary; once it drains, multi-step dispatches.

Memory: the decode state and the control block are updated in place (a
decode step writes each layer's new carries, or its new KV rows, into the
grid), so serving holds one copy of the state. When ``cfg.pim`` is
enabled the constructor prepacks every projection weight once (the
paper's program-subarrays-once step) and prefill/decode never re-quantize
a weight (a tied head, which stays float, quantizes at every call, as in
the JAX package).

Autotune (``autotune="cost"|"measure"``, :mod:`repro_torch.pim.autotune`):
right after prepack every packed weight gets a decision (backend and
kernel-2 tiles) for this deployment's decode shape (m = ``max_batch``;
MoE banks at every expert's capacity rows), recorded in the tuning cache.
Decisions move dispatch only: tokens and logits are the untuned engine's.

Self-healing (``faults``, ``watchdog``; :mod:`repro_torch.pim.faults`):
persistent faults corrupt the packed codes at prepack (re-packed through
kernel 1); transient read disturb strikes every bit-serial product of a
decode step, which runs under ``read_disturb_scope`` with the step's key
(the reference's engine-key split, as a :class:`~repro_torch.pim.faults.
Key`), and the step's logits health is ANDed on the device and read in
the dispatch's one host copy. ``watchdog`` arms per-dispatch supervision:
a shadow of the engine before each dispatch (state and control tensors
cloned, since prefill and decode write them in place; the host
bookkeeping; the sampling generator's state and the key chain, so a retry
draws the same), rollback and bounded-backoff retry on an injected fault,
a device runtime error, non-finite logits or a blown deadline, disk
snapshots on a cadence, and, once the budget is spent, redeployment on
the float path from the masters. ``snapshot``/``restore`` carry the state,
the control block, the generator state and key chain, the slots, the
queue and the tuning decisions through :mod:`repro_torch.training.
checkpoint`.

Later slices (``ROADMAP.md`` Queue 1): mesh serving, pipelined decode and
the gateway. The constructor raises ``NotImplementedError`` for the first
two.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch import disable_tf32
from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.model import (decode_step, init_state,
                                         prefill_into_slot, prepack_params,
                                         to_device)
from repro_torch.pim import faults as _faults
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.fault_tolerance import (RestartPolicy,
                                                  StragglerDetector,
                                                  WatchdogConfig)

from .gateway import Ring
from .sampler import SamplerConfig, sample_per_slot
from .vision import refuse_unported, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (L,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                # -1: never
    deadline_ms: float | None = None   # latency budget, for the gateway


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list


def _clone(tree):
    """A copy of a tree of tensors (dicts and lists), every tensor cloned."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _pow2_chunks(n: int) -> list[int]:
    """Binary decomposition, largest first: 13 -> [8, 4, 1]."""
    out = []
    b = 1 << max(n.bit_length() - 1, 0)
    while n:
        if n >= b:
            out.append(b)
            n -= b
        b >>= 1
    return out


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_len: int = 512, sampler: SamplerConfig | None = None,
                 seed: int = 0, drain_steps: int = 8, device="cuda",
                 mesh=None, faults=None, watchdog=None, fault_injector=None,
                 keep_masters: bool = False, autotune: str = "off",
                 tuning_cache=None, pipeline_stages: int = 1,
                 pipeline_microbatches: int | None = None):
        if autotune not in ("off", "cost", "measure"):
            raise ValueError(
                f"autotune {autotune!r}: want 'off' | 'cost' | 'measure'")
        refuse_unported("ServeEngine", dict(
            mesh=mesh is not None,
            pipeline_stages=pipeline_stages != 1,
            pipeline_microbatches=pipeline_microbatches is not None))
        if not cfg.embed_inputs or cfg.cross_attn_every:
            raise ValueError(
                f"ServeEngine serves token-in archs; {cfg.name} takes stub "
                "frontend embeddings (drive it through prefill and "
                "decode_step, as the JAX package runs them)")
        self.device = resolve_device(device)
        disable_tf32()
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = sampler or SamplerConfig()
        self.drain_steps = max(1, drain_steps)
        self.faults = faults
        self.watchdog = watchdog
        self.fault_injector = fault_injector   # test hook: raises per dispatch
        # Deployment-time quantize + pack, exactly once; persistent faults
        # strike this programming pass (and, with faults.checksum, repair
        # from spares) before the tree serves.
        with torch.no_grad():
            masters = to_device(params, self.device)
            self.params = prepack_params(masters, cfg.pim, faults=faults)
        # The float masters stay on the device under supervision (the
        # degrade-to-float fallback redeploys from them) or on request
        # (``keep_masters``, for :meth:`redeploy`).
        self._raw_params = masters if (watchdog is not None
                                       or keep_masters) else None
        del masters
        self.autotune = autotune
        self._tuning_cache_arg = tuning_cache
        self.tune_cache = None
        self._maybe_autotune()
        self.state = init_state(cfg, max_batch, max_len, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # The reference's engine key, PRNGKey(seed) split once an admission
        # and once a decode step (twice under transient faults): kept as
        # (root seed, chain length) on the host, read only by the
        # read-disturb draws of a decode step.
        self._key_seed, self._key_chain = seed, 0

        def zeros(dtype):
            return torch.zeros((max_batch,), dtype=dtype, device=self.device)

        self.ctrl = {"last_tok": zeros(torch.int32),
                     "eos": torch.full((max_batch,), -1, dtype=torch.int32,
                                       device=self.device),
                     "remaining": zeros(torch.int32),
                     "live": zeros(torch.bool)}
        # Host bookkeeping mirrors (admission decisions + output assembly).
        self.slot_req: list = [None] * max_batch
        self.slot_out: list = [[] for _ in range(max_batch)]
        self.slot_remaining = np.zeros(max_batch, np.int32)
        self.queue: collections.deque = collections.deque()
        self.done: list = []
        self._cancelled: set = set()   # rids to release at the next boundary
        # Supervision state (inert unless watchdog/fault_injector set).
        wd = watchdog or WatchdogConfig()
        self._policy = RestartPolicy(wd.max_failures, wd.backoff_s)
        self._detector = StragglerDetector(wd.straggler_z)
        self._last_ok = True
        self.health = {"dispatches": 0, "rollbacks": 0, "stragglers": 0,
                       "snapshots": 0, "degraded": False}
        # Routing telemetry (MoE only): each decode step's fraction of
        # top-k assignments dropped at expert capacity.
        self.rings = {"moe_drop_frac": Ring(512)} if cfg.moe else {}
        self._closed = False

    def _maybe_autotune(self):
        """Attach a TuneDecision to every packed weight of the prepacked
        tree (autotune on and ``cfg.pim`` enabled), for this deployment's
        decode shape (m = ``max_batch``), from the candidates of
        ``autotune.default_backends(device)``. Expert banks decide at the
        rows of every expert's capacity buffer (``moe_m_hint``)."""
        if self.autotune == "off" or not getattr(self.cfg.pim, "enabled",
                                                 False):
            return
        from repro_torch.pim import autotune as _at

        if self.tune_cache is None:
            self.tune_cache = _at.as_cache(self._tuning_cache_arg)
        moe_kw = {}
        if self.cfg.moe:
            from repro_torch.models.lm.moe import _capacity

            moe_kw["moe_m_hint"] = (self.cfg.moe.n_experts
                                    * _capacity(self.max_batch, self.cfg))
        self.params = _at.tune_tree(
            self.params, m_hint=self.max_batch, a_bits=self.cfg.pim.a_bits,
            backends=_at.default_backends(self.device), mode=self.autotune,
            cache=self.tune_cache, device=self.device, **moe_kw)

    # -- device paths --------------------------------------------------------

    def _admit_ctrl(self, logits, slot: int, eos_id: int, n_new: int):
        """Sample the first token and write slot ``slot``'s control
        entries, on the device."""
        tok = sample_per_slot(logits[:, -1], self.sampler, self.generator)
        c, s = self.ctrl, slice(slot, slot + 1)
        c["last_tok"][s] = tok
        c["eos"][s] = eos_id
        c["remaining"][s] = n_new - 1
        c["live"][s] = (tok != eos_id) & (n_new > 1)
        self._key_chain += 1
        return tok

    @property
    def _transient(self) -> bool:
        return self.faults is not None and self.faults.transient

    def _decode_n(self, n: int):
        """``n`` fused decode + sample steps. Returns the (n, B) tokens and
        done flags, read to the host in one copy; an MoE engine's per-step
        drop fractions stay on the device until one more copy after the
        loop, and go into its ring. Under transient faults each step
        decodes under ``read_disturb_scope`` with its own key, and the
        steps' logits health (all finite) is ANDed on the device and read
        in the same copy (``_last_ok``)."""
        c = self.ctrl
        out, drops = [], []
        ok = torch.ones((), dtype=torch.bool, device=self.device) \
            if self._transient else None
        for _ in range(n):
            length = self.state["length"].clone()
            if self._transient:
                # key0, dkey = split(key): the step's disturb key.
                dkey = _faults.Key.root(self._key_seed).chain(
                    self._key_chain).split(2, 1)
                self._key_chain += 1
                with _faults.read_disturb_scope(self.faults, dkey):
                    res = decode_step(self.params, self.cfg,
                                      c["last_tok"][:, None], self.state,
                                      return_stats=bool(self.rings))
                ok &= torch.isfinite(res[0]).all()
            else:
                res = decode_step(self.params, self.cfg,
                                  c["last_tok"][:, None], self.state,
                                  return_stats=bool(self.rings))
            self._key_chain += 1
            logits, self.state = res[:2]
            if self.rings:
                drops.append(res[2]["moe_drop_frac"])
            nxt = sample_per_slot(logits[:, 0], self.sampler, self.generator)
            nxt = torch.where(c["live"], nxt, c["last_tok"])
            c["remaining"] -= c["live"].to(torch.int32)
            done = c["live"] & ((nxt == c["eos"]) | (c["remaining"] <= 0))
            # Dead slots do not advance.
            self.state["length"] = torch.where(c["live"],
                                               self.state["length"], length)
            c["live"] &= ~done
            c["last_tok"] = nxt
            out.append(torch.stack([nxt, done.to(torch.int32)]))
        out = torch.stack(out)                        # (n, 2, B)
        if ok is None:
            out = out.cpu().numpy()
        else:
            flat = torch.cat([out.flatten(), ok.to(torch.int32)[None]])
            flat = flat.cpu().numpy()
            out, self._last_ok = flat[:-1].reshape(out.shape), bool(flat[-1])
        if drops:
            for v in torch.stack(drops).cpu().numpy():
                self.rings["moe_drop_frac"].push(float(v))
        return out[:, 0], out[:, 1].astype(bool)

    # -- public API ---------------------------------------------------------

    def validate(self, prompt, max_new_tokens: int):
        """Admission-time request validation: a prompt that leaves no room
        for ``max_new_tokens`` in the (max_batch, max_len) grid, the empty
        prompt (no logits to sample the first token from) and a
        non-positive budget are refused."""
        n = len(prompt)
        if n == 0:
            raise ValueError("empty prompt: nothing to prefill, no final "
                             "logits to sample the first token from")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        if n + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({n} tokens) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the decode grid (max_len={self.max_len})")

    def submit(self, req: Request):
        if self._closed:
            raise RuntimeError("ServeEngine.submit after close()")
        self.validate(req.prompt, req.max_new_tokens)
        self.queue.append(req)

    def cancel(self, rid: int) -> str | None:
        """Cancel a request. Queued: removed immediately. Mid-generation:
        its slot is released at the next token boundary through the same
        slot-free path a natural completion takes, and the next occupant's
        prefill zeroes the recurrent carries. Returns "queued" / "active"
        for what was cancelled, None if the rid is unknown."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                return "queued"
        for r in self.slot_req:
            if r is not None and r.rid == rid:
                self._cancelled.add(rid)
                return "active"
        return None

    @property
    def n_free_slots(self) -> int:
        """Slots an admission could land in right now: free grid slots not
        already spoken for by queued requests (the JAX engine's property,
        which its gateway admits through)."""
        return max(0, len(self._free_slots()) - len(self.queue))

    def _release_cancelled(self):
        """Free cancelled slots at a token boundary: clear the host slot and
        kill the slot's device liveness."""
        hit = [i for i, r in enumerate(self.slot_req)
               if r is not None and r.rid in self._cancelled]
        self._cancelled.clear()
        for i in hit:
            self.ctrl["live"][i] = False
            self.ctrl["remaining"][i] = 0
            self.slot_req[i] = None
            self.slot_out[i] = []
            self.slot_remaining[i] = 0

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self):
        """Prefill queued requests into free slots, chunked power-of-two."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            prompt = torch.from_numpy(np.asarray(req.prompt, np.int32)).to(
                self.device)[None]
            pos, logits = 0, None
            for c in _pow2_chunks(prompt.shape[1]):
                logits, self.state = prefill_into_slot(
                    self.params, self.cfg, prompt[:, pos:pos + c], self.state,
                    slot, pos)
                pos += c
            first = int(self._admit_ctrl(logits, slot, req.eos_id,
                                         req.max_new_tokens))
            self.slot_out[slot] = [first]
            if req.max_new_tokens <= 1 or first == req.eos_id:
                self.done.append(Completion(req.rid, self.slot_out[slot]))
                continue
            self.slot_req[slot] = req
            self.slot_remaining[slot] = req.max_new_tokens - 1

    @torch.no_grad()
    def step(self) -> list:
        """Admit + decode (one step, or a drain of up to ``drain_steps``
        fused steps when no admissions are pending); returns completions.

        With a watchdog (or fault injector) armed, the dispatch runs
        supervised (:meth:`_step_supervised`)."""
        if self._cancelled:
            # Before the shadow: a rollback must not resurrect a cancelled
            # request.
            self._release_cancelled()
        if self.watchdog is None and self.fault_injector is None:
            return self._step_once(count=True)
        return self._step_supervised()

    def _step_once(self, count: bool = False) -> list:
        """One unsupervised dispatch. ``count``: count a decode dispatch in
        ``health`` (the supervised path counts each successful step)."""
        self._admit()
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return self._drain_done()
        if self.queue:
            n = 1   # keep admissions responsive: a slot may free next token
        else:
            cap = max(1, min(self.drain_steps,
                             int(max(self.slot_remaining[i] for i in live))))
            n = 1 << (cap.bit_length() - 1)
        toks, dones = self._decode_n(n)
        if count:
            self.health["dispatches"] += 1
        for k in range(n):
            for i in list(live):
                req = self.slot_req[i]
                self.slot_out[i].append(int(toks[k, i]))
                self.slot_remaining[i] -= 1
                if dones[k, i]:
                    self.done.append(Completion(req.rid, self.slot_out[i]))
                    self.slot_req[i] = None
                    live.remove(i)
        return self._drain_done()

    def _drain_done(self):
        out, self.done = self.done, []
        return out

    def stats(self) -> dict:
        """Telemetry snapshot in the JAX engine's form: ``{"health": ...}``
        (``dispatches``, ``rollbacks``, ``stragglers``, ``snapshots``,
        ``degraded``) plus the ring-buffer channels (MoE engines:
        ``moe_drop_frac``, each decode step's fraction of top-k routing
        assignments dropped at expert capacity, as ``p50``/``p95``/``p99``,
        ``n`` and ``mean``); a dense engine has no channel."""
        out = {"health": dict(self.health)}
        for name, ring in self.rings.items():
            v = ring.values()
            out[name] = dict(ring.percentiles(), n=len(ring),
                             mean=float(v.mean()) if len(ring) else None)
        return out

    # -- watchdog supervision -------------------------------------------------

    def _shadow(self):
        """In-memory rollback point: the state and control tensors cloned
        (prefill and decode write them in place), the host bookkeeping,
        the sampling generator's state and the key chain."""
        dev = _clone({"state": self.state, "ctrl": self.ctrl})
        return (dev, list(self.slot_req), [list(o) for o in self.slot_out],
                self.slot_remaining.copy(), collections.deque(self.queue),
                list(self.done), self.generator.get_state(),
                (self._key_seed, self._key_chain))

    def _restore_shadow(self, shadow):
        dev, reqs, outs, rem, queue, done, gen, key = shadow
        self.state, self.ctrl = dev["state"], dev["ctrl"]
        self.slot_req, self.slot_out = reqs, outs
        self.slot_remaining, self.queue, self.done = rem, queue, done
        self.generator.set_state(gen)
        self._key_seed, self._key_chain = key

    def _step_supervised(self) -> list:
        """Shadow -> dispatch -> health checks, rollback + retry on failure.

        Failure channels: the ``fault_injector`` hook raising, a device
        runtime error (each a ``RuntimeError``), the non-finite-logit flag
        (transient faults) and a dispatch past ``deadline_s``. Each failure
        restores the shadow (completions drained by the failed dispatch
        are part of it, so no token is emitted twice) and retries after
        ``RestartPolicy`` backoff; a spent budget degrades to the float
        path (``degrade=True``) or re-raises. ``health["dispatches"]``
        counts each successful dispatch once.
        """
        wd = self.watchdog
        while True:
            shadow = self._shadow()
            t0 = time.monotonic()
            try:
                if self.fault_injector is not None:
                    self.fault_injector(self.health["dispatches"])
                out = self._step_once()
                dt = time.monotonic() - t0
                if self._detector.observe(dt):
                    self.health["stragglers"] += 1
                if wd is not None and wd.deadline_s is not None \
                        and dt > wd.deadline_s:
                    raise RuntimeError(
                        f"watchdog: dispatch took {dt:.3f}s "
                        f"> deadline {wd.deadline_s}s")
                if not self._last_ok:
                    raise RuntimeError(
                        "watchdog: non-finite logits in dispatch")
            except RuntimeError as e:
                self._restore_shadow(shadow)
                self._last_ok = True
                self.health["rollbacks"] += 1
                try:
                    wait = self._policy.on_failure()
                except RuntimeError:
                    if wd is not None and wd.degrade \
                            and self._raw_params is not None \
                            and getattr(self.cfg.pim, "enabled", False):
                        print(f"[serve-watchdog] budget spent ({e!r}); "
                              "degrading to float path", flush=True)
                        self._degrade_to_float()
                        continue
                    raise
                print(f"[serve-watchdog] dispatch failed: {e!r}; "
                      f"rollback + retry in {wait:.2f}s", flush=True)
                time.sleep(min(wait, 0.05))  # bounded for tests; real: full
                continue
            self.health["dispatches"] += 1
            self._policy.record_progress(self.health["dispatches"])
            if wd is not None and wd.snap_every and wd.ckpt_dir \
                    and self.health["dispatches"] % wd.snap_every == 0:
                self.snapshot(wd.ckpt_dir, step=self.health["dispatches"])
                self.health["snapshots"] += 1
            return out

    def redeploy(self, pim_cfg):
        """Re-prepack from the float masters under a new PIM config (and
        re-tune): the degrade machinery, parameterized so a serving cohort
        can move to another precision (or back). The decode state and the
        control block carry over, so in-flight generations continue on
        the new path. Needs the masters (``keep_masters=True`` or a
        watchdog)."""
        if self._raw_params is None:
            raise RuntimeError(
                "redeploy needs the float masters; construct the engine "
                "with keep_masters=True (or a watchdog)")
        self.cfg = dataclasses.replace(self.cfg, pim=pim_cfg)
        with torch.no_grad():
            self.params = prepack_params(self._raw_params, pim_cfg,
                                         faults=self.faults)
        self._maybe_autotune()   # new precision -> fresh (cached) decisions

    def _degrade_to_float(self):
        """Sustained fault pressure: redeploy on the float path from the
        golden masters and keep serving."""
        self.faults = None
        self._last_ok = True
        self.redeploy(dataclasses.replace(self.cfg.pim, enabled=False))
        wd = self.watchdog
        self._policy = RestartPolicy(wd.max_failures, wd.backoff_s)
        self.health["degraded"] = True

    # -- snapshot / restore ----------------------------------------------------

    @staticmethod
    def _req_dict(r: Request) -> dict:
        return {"rid": r.rid, "prompt": np.asarray(r.prompt).tolist(),
                "max_new_tokens": r.max_new_tokens, "eos_id": r.eos_id,
                "deadline_ms": r.deadline_ms}

    @staticmethod
    def _req_from(s: dict) -> Request:
        return Request(rid=s["rid"], prompt=np.asarray(s["prompt"], np.int32),
                       max_new_tokens=s["max_new_tokens"], eos_id=s["eos_id"],
                       deadline_ms=s.get("deadline_ms"))

    def _device_tree(self) -> dict:
        """What a snapshot saves: the state, and the control block with
        the key (root seed, chain length) and the sampling generator's
        state."""
        key = torch.tensor([self._key_seed, self._key_chain],
                           dtype=torch.int64)
        return {"state": self.state,
                "ctrl": dict(self.ctrl, key=key,
                             generator=self.generator.get_state())}

    def snapshot(self, ckpt_dir: str, step: int = 0):
        """Checkpoint the state, the control block (with the key and the
        generator state), the slot bookkeeping and the queued requests
        (re-enqueued by :meth:`restore`). Safe mid-generation: saving
        copies to the host."""
        slots = []
        for i, r in enumerate(self.slot_req):
            slots.append(None if r is None else dict(
                self._req_dict(r), out=list(self.slot_out[i]),
                remaining=self.slot_remaining[i]))
        extra = {"slots": slots,
                 "queue": [self._req_dict(r) for r in self.queue],
                 "max_batch": self.max_batch,
                 "max_len": self.max_len}
        if self.tune_cache is not None:
            extra["tuning"] = self.tune_cache.to_extra()
        ckpt.save(ckpt_dir, step, self._device_tree(), extra=extra)

    def restore(self, ckpt_dir: str, step: int | None = None):
        """Resume mid-generation from :meth:`snapshot` (same cfg and
        grid). The saved key and generator state replace this engine's,
        so a restored engine draws what the saved one would have."""
        tree, manifest = ckpt.restore(ckpt_dir, self._device_tree(),
                                      step=step)
        ctrl = tree["ctrl"]
        self._key_seed, self._key_chain = (int(v) for v in ctrl.pop("key"))
        self.generator.set_state(ctrl.pop("generator"))
        self.state, self.ctrl = tree["state"], ctrl
        for i, s in enumerate(manifest["extra"]["slots"]):
            if s is None:
                self.slot_req[i] = None
                self.slot_out[i] = []
                self.slot_remaining[i] = 0
            else:
                self.slot_req[i] = self._req_from(s)
                self.slot_out[i] = list(s["out"])
                self.slot_remaining[i] = s["remaining"]
        self.queue = collections.deque(
            self._req_from(s) for s in manifest["extra"].get("queue", []))
        if self.tune_cache is not None:
            self.tune_cache.merge_extra(manifest["extra"].get("tuning"))
        return manifest

    def close(self):
        """Engine teardown: drop the device tensors the engine holds (the
        prepacked weights, the masters, the decode grid, the control block
        and the generator), so their memory returns to the allocator, and
        refuse further work. ``stats()`` still answers. The tuning cache is
        reset, so a later engine sharing the cache object re-reads its
        (possibly repaired) backing file instead of serving this engine's
        stale fallback memo."""
        if self.tune_cache is not None:
            self.tune_cache.reset()
        self.params = self.state = self.ctrl = self.generator = None
        self._raw_params = None
        self.queue.clear()
        self.slot_req = [None] * self.max_batch
        self._closed = True

    def run(self, max_steps: int = 10_000, strict: bool = False) -> list:
        """Drive until queue + slots drain; returns all completions.

        Exhausting ``max_steps`` with work still in flight warns with the
        stranded requests, or raises when ``strict=True``.
        """
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and all(r is None for r in self.slot_req):
                return out
        live = [r.rid for r in self.slot_req if r is not None]
        queued = [r.rid for r in self.queue]
        if live or queued:
            msg = (f"run(max_steps={max_steps}) exited with "
                   f"{len(live) + len(queued)} stranded request(s): "
                   f"rids {live} mid-generation, rids {queued} queued")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return out
