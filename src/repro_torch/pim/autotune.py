"""Cost-model-driven backend/tiling autotuner.

The best Eq. 1 backend flips with shape and precision: the popcount
dataflow scales with the W*I plane-pair count, the direct integer product
is precision-flat, and the plane-product path sits in between, so a fixed
backend leaves time on the table somewhere in every deployment. This
module lets the paper's own chip/bank/subarray mapper
(:func:`repro_torch.pim.mapper.map_gemm`) and its price list
(:class:`repro_torch.pim.cost_model.CostModel`) rank the real candidates,
and ships the verdict to prepack time as a
:class:`~repro_torch.core.packed.TuneDecision` on each packed weight.

Pipeline per (m, k, n, <W:I>) GEMM:

  1. enumerate candidates: one per library backend, plus the legalized
     tile requests of kernel 2 (``kernels.ops.matmul_tiles``) when "cuda"
     is allowed;
  2. rank analytically: ``map_gemm`` expands the candidate's schedule into
     subarray micro-ops (plane pairs for the bit-serial backends, one
     full-width pass for int-direct), ``CostModel`` prices them, and a
     per-backend rate (``_RATES``, by device) turns the NAND-SPIN price
     into a relative time; a "cuda" candidate's tile factor
     (:func:`_tile_factor`) orders its launch plans;
  3. near-ties (within ``_TIE_BAND``) are broken by :func:`roofline_time`,
     max(operations / peak, bytes / bandwidth) of what the candidate's
     dispatch reads and does, at the H100's data-sheet peaks;
  4. ``mode="measure"`` times the best candidate of each backend
     (injectable ``measure``; the default, :func:`measure_gemm`, makes
     operands once on the device) and picks the fastest;
  5. the decision persists in a :class:`TuningCache`: a JSON file keyed
     by (shape, precision, backend set, device kind) and stamped with a
     hash of the modules and CUDA sources that define the kernels'
     semantics, so editing a kernel stales the cache instead of serving
     outdated picks.

Tuning may change speed, never bits: every backend and launch plan
computes the same integer P (mod 2^32).

The counterpart of the JAX package's ``repro.pim.autotune``: "cuda" takes
the place of "pallas", the library backends that of its XLA backends, and
every function that reads a device takes it as ``device=`` (None is the
CPU).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
import time
import warnings

import torch

from repro_torch.core.packed import (PackedConvWeight, PackedWeight,
                                     TuneDecision, prepack)
from repro_torch.models.cnn.specs import GemmSpec

from .cost_model import CostModel
from .hierarchy import Geometry
from .mapper import map_gemm

# Backends that run everywhere (the JAX package's XLA backends): "popcount"
# runs kernels 1 and 4 on a CUDA tensor, the other two a library product.
# "cuda" (kernel 2) joins the set on a CUDA device (default_backends): on
# the CPU it runs its plain version, a semantics oracle, not a contender.
LIBRARY_BACKENDS = ("popcount", "mxu-plane", "int-direct")
ALL_BACKENDS = LIBRARY_BACKENDS + ("cuda",)

# Kernel 2's tile request lattice; every point is legalized against the
# actual (m, n, kw) by kernels.ops.matmul_tiles before it becomes a
# candidate, so the set collapses for small operands. A bkw of None keeps
# the plan's own K split (two blocks an SM).
_TILE_BM = (16, 64)
_TILE_BN = (128,)
_TILE_BKW = (None, 32, 128, 512)

# Relative schedule drain rates per backend and device: each candidate's
# time estimate is its mapper price divided by this factor (popcount = 1.0
# defines the unit). int-direct's single full-width pass is priced by
# map_gemm(ab=wb=1), whose cost relative to the plane-pair sweep shrinks
# as W*I grows, so one flat rate places the precision crossover.
# "default" (the CPU) is the JAX package's own row, "cuda" in place of
# "pallas", so CPU decisions equal the reference's. "cuda" is fitted on an
# NVIDIA H100 80GB HBM3 at its 700 W limit by chip_smoke.py's
# fit_cuda_rates, over 10^(i/4), for the rates whose cost-mode pick is the
# measured-fastest backend (measure_gemm) on the most GEMMs, counted on
# the traffic each candidate set decides: autotune_bench's 5 shapes x
# <2:2>, <4:4>, <8:8> among all four backends (FC and projection weights)
# and among the library three (MoE banks), and the 50 distinct conv GEMMs
# of ResNet-50 and AlexNet at buckets 8 and 4 among the library three
# (conv weights), priced at conv_m_hint's rows and timed at the rows
# served. Ties go to the rates whose predicted time ratios are nearest
# the measured ones. These match on 15 of 15, 15 of 15 and 49-50 of 50
# in three runs (the "default" row on the grid: 0 and 10 of 15): kernel 2
# is the fastest everywhere, then popcount, int-direct and mxu-plane; a
# miss is a conv GEMM where popcount and int-direct run within the
# host's noise of each other (1-14%).
_RATES = {
    "default": {"popcount": 1.0, "mxu-plane": 0.4, "int-direct": 0.2,
                "cuda": 0.9},
    "cuda": {"popcount": 1.0, "mxu-plane": 0.03162, "int-direct": 0.01778,
             "cuda": 1.778},
}

_TIE_BAND = 1.10          # analytic near-tie band feeding the tie-break
# measure_gemm on a CUDA device: the median of _CUDA_ROUNDS rounds of
# _CUDA_ITERS calls (a call there takes tens of microseconds, so two calls
# would read the host's jitter); on the CPU two calls, the JAX package's.
_CUDA_ITERS = 20
_CUDA_ROUNDS = 3
_GEO = Geometry()

# NVIDIA H100 SXM data sheet (dense): memory 3.35 TB/s; int8 tensor cores
# 1,979 TOP/s (kernels 2 and 4 run u8 mma.sync); float32 outside the
# tensor cores and float64 on them, 67 TFLOP/s each; 132 SMs.
_HBM_BYTES_PER_S = 3.35e12
_INT8_OPS_PER_S = 1.979e15
_FP32_FLOPS_PER_S = 67e12
_FP64_FLOPS_PER_S = 67e12
_H100_SMS = 132


# ---------------------------------------------------------------------------
# Environment fingerprints
# ---------------------------------------------------------------------------

def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` lowercased with ``-`` for spaces on
    a CUDA device, else the device type ("cpu", the JAX package's CPU
    kind, so CPU keys equal the reference's)."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).replace(" ", "-").lower()
    return device.type


@functools.lru_cache(maxsize=1)
def code_version() -> str:
    """Hash of the modules and CUDA sources defining kernel semantics, and
    of this ranker.

    A cache entry is only as good as the code that produced and consumes
    it: editing a kernel, its launch planner or the autotuner must stale
    every persisted decision (fall back to fresh cost-model picks), never
    silently serve them.
    """
    import importlib

    from repro_torch.kernels import _build

    mods = [importlib.import_module(m) for m in
            ("repro_torch.core.bitserial", "repro_torch.kernels.ops",
             "repro_torch.kernels.bitplane_pack",
             "repro_torch.kernels.bitserial_matmul",
             "repro_torch.kernels.conv2d_fused")]
    files = [m.__file__ for m in mods] + [__file__]
    files += sorted({str(p) for name in ("bitplane_pack", "bitserial_matmul",
                                         "conv2d_fused")
                     for p in _build._sources(name)})
    h = hashlib.md5()
    for f in files:
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def _rates(device=None) -> dict:
    device = torch.device("cpu" if device is None else device)
    return _RATES["cuda" if device.type == "cuda" else "default"]


def default_backends(device=None) -> tuple:
    """Candidate set for engine prepack: the library backends everywhere,
    plus "cuda" on a CUDA device."""
    device = torch.device("cpu" if device is None else device)
    out = LIBRARY_BACKENDS
    if device.type == "cuda":
        out = out + ("cuda",)
    return out


# ---------------------------------------------------------------------------
# Candidate enumeration + analytic ranking
# ---------------------------------------------------------------------------

def gemm_candidates(m: int, k: int, n: int, a_bits: int, w_bits: int,
                    backends=LIBRARY_BACKENDS) -> list:
    """One TuneDecision per library backend + kernel 2's legalized tile
    set."""
    from repro_torch.kernels import ops as _kops

    out = []
    for be in backends:
        if be != "cuda":
            out.append(TuneDecision(backend=be))
            continue
        kw = max(1, -(-k // 32))
        seen = set()
        for bm in _TILE_BM:
            for bn in _TILE_BN:
                for bkw in _TILE_BKW:
                    t = _kops.matmul_tiles(m, n, kw, a_bits, w_bits,
                                           bm, bn, bkw)
                    if t in seen:
                        continue
                    seen.add(t)
                    out.append(TuneDecision(backend="cuda", bm=t[0],
                                            bn=t[1], bkw=t[2]))
    return out


def _gemm_spec(m: int, k: int, n: int) -> GemmSpec:
    return GemmSpec(name="autotune", kind="fc", m=m, k=k, n=n,
                    out_elems=m * n, in_elems=m * k, weight_elems=k * n)


def _price(spec: GemmSpec, ab: int, wb: int) -> float:
    """NAND-SPIN schedule latency for one (ab x wb)-plane GEMM pass."""
    cm = CostModel(_GEO)
    oc = map_gemm(spec, _GEO, ab, wb)
    c = cm.price_rowops(oc)
    c += cm.price_programs(oc)
    c += cm.price_bus(oc)
    c += cm.price_local(oc)
    return c.latency


def _plan_time(m: int, n: int, plan) -> float:
    """Relative time of one kernel-2 launch plan on the H100: blocks
    issue in waves of two an SM; a block's time grows with the words of K
    it sums and, for its mma work, with the tile's rows; each extra split
    adds its atomic adds."""
    from repro_torch.kernels import bitserial_matmul as _bsm

    tm, tn, _ = _bsm.TILES[plan.variant]
    blocks = -(-m // tm) * -(-n // tn) * plan.splits
    waves = -(-blocks // (2 * _H100_SMS))
    return (waves * plan.split_words * (1 + tm / 64)
            * (1.0 + 0.002 * (plan.splits - 1)))


def _tile_factor(m: int, k: int, n: int, a_bits: int, w_bits: int,
                 d: TuneDecision) -> float:
    """Kernel-2 tile quality multiplier: the candidate's launch plan's time
    over the untuned plan's (:func:`_plan_time`). Purely relative: it
    orders the tile candidates of one shape, nothing else."""
    from repro_torch.kernels import bitserial_matmul as _bsm
    from repro_torch.kernels import ops as _kops

    kw = max(1, -(-k // 32))
    bm, _, bkw = _kops.matmul_tiles(m, n, kw, a_bits, w_bits,
                                    d.bm, d.bn, d.bkw)
    plan = _bsm._plan(m, n, kw, _H100_SMS, 1, bm, bkw)
    return (_plan_time(m, n, plan)
            / _plan_time(m, n, _bsm._plan(m, n, kw, _H100_SMS)))


def analytic_gemm_cost(m: int, k: int, n: int, a_bits: int, w_bits: int,
                       d: TuneDecision, device=None) -> float:
    """Relative execution-time estimate of one candidate (see module doc).

    The bit-serial backends run the full ab x wb plane-pair schedule; the
    direct integer product is one full-width pass (ab = wb = 1 in the
    mapper's schedule) whose row-ops retire at the backend's own rate.
    """
    spec = _gemm_spec(m, k, n)
    if d.backend == "int-direct":
        base = _price(spec, 1, 1)
    else:
        base = _price(spec, a_bits, w_bits)
    t = base / _rates(device)[d.backend]
    if d.backend == "cuda":
        t *= _tile_factor(m, k, n, a_bits, w_bits, d)
    return t


# ---------------------------------------------------------------------------
# Roofline tie-break + measurement refinement
# ---------------------------------------------------------------------------

def roofline_time(m: int, k: int, n: int, a_bits: int, w_bits: int,
                  backend: str) -> float | None:
    """Roofline time of one candidate's dispatch (tie-break only): max(
    operations / peak, bytes / bandwidth) of what ``int_matmul_prepacked``
    reads, writes and computes on that backend, at the H100's data-sheet
    peaks. (The JAX package walks the compiled HLO instead; a PyTorch
    dispatch has no HLO, so the port counts the same terms by hand.) None
    for an unknown backend."""
    kw = max(1, -(-k // 32))
    qa, out = 4 * m * k, 4 * m * n                 # int32 codes in, P out
    if backend in ("popcount", "cuda"):
        planes = 4 * w_bits * n * kw
        # popcount packs the codes' planes first, then reads them back.
        packed = 2 * 4 * a_bits * m * kw if backend == "popcount" else 0
        return max(2 * m * n * k / _INT8_OPS_PER_S,
                   (qa + planes + packed + out) / _HBM_BYTES_PER_S)
    if backend == "mxu-plane":
        # Both operands' {0,1} planes as float32, written then read; the
        # float32 counts, and the int64 shifts summed into P.
        planes = 2 * 4 * (a_bits * m * k + w_bits * k * n)
        counts = 4 * a_bits * w_bits * m * n + 8 * a_bits * w_bits * m * n
        return max(2 * (a_bits * m) * k * (w_bits * n) / _FP32_FLOPS_PER_S,
                   (qa + k * n + planes + counts + out) / _HBM_BYTES_PER_S)
    if backend == "int-direct":
        # Both operands widened to float64, one float64 product, then
        # int64 and int32 views of it.
        wide = 2 * 8 * (m * k + k * n) + 8 * m * n + 8 * m * n
        return max(2 * m * k * n / _FP64_FLOPS_PER_S,
                   (qa + k * n + wide + out) / _HBM_BYTES_PER_S)
    return None


def measure_gemm(d: TuneDecision, m: int, k: int, n: int, a_bits: int,
                 w_bits: int, iters: int | None = None,
                 device=None) -> float | None:
    """Default measurement hook: time one candidate on synthetic operands
    through the real prepacked dispatch. Returns seconds a call, or None
    when the candidate refuses the operands (``ValueError``: bits, K or
    indices past what it takes) or runs out of device memory; it is then
    dropped, not picked. Any other failure (a kernel that does not build
    or launch) propagates: no fallback hides it.

    Operands come from a ``torch.Generator`` on the device. One call warms
    the path (and builds the kernel). On a CUDA device ``iters`` calls
    (default ``_CUDA_ITERS``) are then timed with CUDA events after a
    synchronise, ``_CUDA_ROUNDS`` times, and the median round counts; on
    the CPU ``iters`` calls (default 2) with ``perf_counter``."""
    from repro_torch.core.bitserial import int_matmul_prepacked

    device = torch.device("cpu" if device is None else device)
    try:
        with torch.inference_mode():
            gen = torch.Generator(device=device).manual_seed(0)
            qa = torch.randint(0, 2 ** a_bits, (m, k), generator=gen,
                               dtype=torch.int32, device=device)
            pk = attach(prepack(torch.randn((k, n), generator=gen,
                                            device=device), w_bits), d)
            int_matmul_prepacked(qa, pk, a_bits)          # build + warm
            if device.type == "cuda":
                iters = iters or _CUDA_ITERS
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                rounds = []
                for _ in range(_CUDA_ROUNDS):
                    start.record()
                    for _ in range(iters):
                        int_matmul_prepacked(qa, pk, a_bits)
                    end.record()
                    end.synchronize()
                    rounds.append(start.elapsed_time(end) / 1e3 / iters)
                return sorted(rounds)[len(rounds) // 2]
            iters = iters or 2
            t0 = time.perf_counter()
            for _ in range(iters):
                int_matmul_prepacked(qa, pk, a_bits)
            return (time.perf_counter() - t0) / iters
    except (ValueError, torch.cuda.OutOfMemoryError):
        return None


# ---------------------------------------------------------------------------
# Decisions
# ---------------------------------------------------------------------------

def gemm_key(m: int, k: int, n: int, a_bits: int, w_bits: int,
             backends, device=None) -> str:
    return (f"gemm:{m}x{k}x{n}:<{w_bits}:{a_bits}>:"
            f"be={'+'.join(sorted(backends))}:dev={device_kind(device)}")


def conv_key(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
             stride: int, padding: int, a_bits: int, w_bits: int,
             backends, device=None) -> str:
    return (f"conv:{n}x{h}x{w}x{c}:o{o}:k{kh}x{kw}:s{stride}p{padding}:"
            f"<{w_bits}:{a_bits}>:be={'+'.join(sorted(backends))}:"
            f"dev={device_kind(device)}")


def decide_gemm(m: int, k: int, n: int, a_bits: int, w_bits: int, *,
                backends=None, mode: str = "cost", cache=None,
                measure=None, hlo_tiebreak: bool = True,
                device=None) -> TuneDecision:
    """Pick (backend, tiles) for an (m, k, n) <W:I> GEMM on ``device``.

    Deterministic for a fixed cache and candidate set: the analytic
    ranking is pure arithmetic, near-ties resolve by the roofline tie-break
    (``hlo_tiebreak``, the JAX package's name; itself deterministic) and
    finally by enumeration order. ``mode="measure"`` additionally times
    the best candidate per backend (``measure(decision, m, k, n, a_bits,
    w_bits) -> seconds | None``; default :func:`measure_gemm` on
    ``device``) and picks the fastest.
    """
    if mode not in ("cost", "measure"):
        raise ValueError(f"autotune mode {mode!r}: want 'cost' | 'measure'")
    backends = tuple(backends) if backends else LIBRARY_BACKENDS
    key = gemm_key(m, k, n, a_bits, w_bits, backends, device)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
    cands = gemm_candidates(m, k, n, a_bits, w_bits, backends)
    scored = sorted(
        (analytic_gemm_cost(m, k, n, a_bits, w_bits, d, device), i, d)
        for i, d in enumerate(cands))
    best_cost, _, best = scored[0]

    if hlo_tiebreak:
        # The best candidate of each backend inside the band (a backend's
        # tile candidates share one roofline).
        ties = {}
        for c, _, d in scored:
            if c <= best_cost * _TIE_BAND:
                ties.setdefault(d.backend, d)
        if len(ties) > 1:
            rt = [(roofline_time(m, k, n, a_bits, w_bits, d.backend), i, d)
                  for i, d in enumerate(ties.values())]
            rt = [x for x in rt if x[0] is not None]
            if rt:
                best = min(rt)[2]

    if mode == "measure":
        measure = measure or functools.partial(measure_gemm, device=device)
        # Top analytic candidate per backend; measurement settles between
        # backends, the analytic order settles tiles within one.
        heads = {}
        for c, i, d in scored:
            heads.setdefault(d.backend, d)
        timed = [(t, i, d) for i, d in enumerate(heads.values())
                 if (t := measure(d, m, k, n, a_bits, w_bits)) is not None]
        if timed:
            best = min(timed)[2]

    if cache is not None:
        cache.put(key, best, mode=mode)
    return best


def decide_conv(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
                *, stride: int = 1, padding: int = 0, a_bits: int = 8,
                w_bits: int = 8, backends=None, mode: str = "cost",
                cache=None, measure=None, device=None) -> tuple:
    """Pick (conv_mode, bo, backend) for a conv layer; returns the pair
    (conv decision, im2col-matmul decision) that :func:`attach_conv`
    installs on a :class:`PackedConvWeight`.

    Candidates: the materialized im2col path per allowed backend (priced
    as the underlying GEMM plus the patch-matrix bus traffic the paper's
    fused schedule never pays: zero for 1x1 kernels, where im2col is a
    reshape), and the fused implicit-im2col kernel (kernel 3) per O block
    when "cuda" is allowed. Kernel 3 has one O block, so its three
    candidates differ in price only, as in the JAX package.
    """
    if mode not in ("cost", "measure"):
        raise ValueError(f"autotune mode {mode!r}: want 'cost' | 'measure'")
    backends = tuple(backends) if backends else LIBRARY_BACKENDS
    ckey = conv_key(n, h, w, c, o, kh, kw, stride, padding, a_bits, w_bits,
                    backends, device)
    if cache is not None:
        hit = cache.get(ckey)
        if hit is not None and isinstance(hit, tuple):
            return hit
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    m, kdim = n * oh * ow, kh * kw * c
    spec = _gemm_spec(m, kdim, o)
    cm = CostModel(_GEO)
    # Patch-matrix blow-up the materialized path streams (int32 codes),
    # priced on the same global bus as the mapper's weight broadcasts.
    patch_bits = 0 if kh == kw == 1 else m * kdim * 32
    patch_t = cm.bus_time(patch_bits)

    scored = []
    for i, be in enumerate(backends):
        if be == "cuda":
            continue
        d = TuneDecision(backend=be, conv_mode="im2col")
        t = analytic_gemm_cost(m, kdim, o, a_bits, w_bits, d, device) \
            + patch_t
        scored.append((t, i, d))
    if "cuda" in backends:
        d = TuneDecision(backend="cuda", conv_mode="im2col")
        scored.append((analytic_gemm_cost(m, kdim, o, a_bits, w_bits, d,
                                          device)
                       + patch_t, len(backends), d))
        base = _price(spec, a_bits, w_bits) / _rates(device)["cuda"]
        for j, bo in enumerate((64, 128, 256)):
            steps = math.ceil(o / min(bo, o))
            t = base * (1.0 + 0.002 * (steps - 1))
            if bo % 128 and bo < min(o, 128):
                t *= 1.2
            scored.append((t, len(backends) + 1 + j,
                           TuneDecision(backend="cuda", conv_mode="fused",
                                        bo=bo)))
    scored.sort()
    best = scored[0][2]
    if mode == "measure" and measure is not None:
        heads, seen = [], set()
        for t, i, d in scored:
            hk = (d.backend, d.conv_mode)
            if hk not in seen:
                seen.add(hk)
                heads.append(d)
        timed = [(t, i, d) for i, d in enumerate(heads)
                 if (t := measure(d)) is not None]
        if timed:
            best = min(timed)[2]
    mat = TuneDecision(backend=best.backend if best.conv_mode == "im2col"
                       else "popcount")
    out = (best, mat)
    if cache is not None:
        cache.put(ckey, out, mode=mode)
    return out


# ---------------------------------------------------------------------------
# Attachment: decisions -> packed-weight trees
# ---------------------------------------------------------------------------

def attach(pw: PackedWeight, d: TuneDecision | None) -> PackedWeight:
    """Install a decision on a packed weight: a new PackedWeight over the
    same tensors (no copy)."""
    return dataclasses.replace(pw, tune=d)


def attach_conv(pcw: PackedConvWeight, d: TuneDecision | None,
                mat: TuneDecision | None = None) -> PackedConvWeight:
    return dataclasses.replace(pcw, tune=d,
                               mat=dataclasses.replace(pcw.mat, tune=mat))


_MOE_EXPERT_NAMES = ("w_in", "w_out", "w_gate")


def _is_expert_path(path) -> bool:
    """True for packed leaves at ``...['ffn']...['w_in'|'w_out'|'w_gate']``
    (a scanned layer's per-rep list index may follow): the MoE expert
    banks (callers only enable the check for MoE configs, where every ffn
    projection is an expert bank)."""
    keys = [k for k in path if isinstance(k, str)]
    return bool(keys) and "ffn" in keys and keys[-1] in _MOE_EXPERT_NAMES


def _map_packed(fn, tree, path=()):
    """``fn(path, leaf)`` at every packed leaf of a tree of dicts, lists
    and tuples; ``path`` holds the dict keys and list indices down to it.
    Other leaves come back as they are."""
    if isinstance(tree, (PackedWeight, PackedConvWeight)):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_packed(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_packed(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def tune_tree(tree, *, m_hint: int, a_bits: int, backends=None,
              mode: str = "cost", cache=None, conv_m_hint: int | None = None,
              measure=None, moe_m_hint: int | None = None, device=None):
    """Attach decisions to every packed leaf of a prepacked param tree.

    ``m_hint`` is the GEMM row count the deployment runs (the serving
    batch for LM decode / the vision FC head); ``conv_m_hint`` bounds the
    conv im2col row count (batch * input map, the stride-1 upper bound:
    the backend crossover is driven by the plane-pair count, which this
    estimate preserves). Decisions dedupe through the cache: the per-rep
    weights of a scanned layer with equal (k, n, bits) decide once.

    ``moe_m_hint`` (MoE deployments): the expert banks' GEMMs run batched
    over every expert's capacity buffer, so their decisions key on the
    E*C dispatch row count instead of the token batch, and rank the
    library backends only, as conv leaves do (the JAX package's candidate
    sets, so decisions stay comparable).
    """
    backends = tuple(backends) if backends else LIBRARY_BACKENDS
    lib_only = tuple(b for b in backends if b != "cuda") or backends

    def visit(path, leaf):
        if isinstance(leaf, PackedConvWeight):
            _, _, _, o = leaf.kernel_shape
            kdim = leaf.mat.codes.shape[-2]
            m = conv_m_hint if conv_m_hint is not None else m_hint
            # Conv decisions from the weight alone: rank the im2col GEMM
            # (the spatial dims ride in conv_m_hint); the fused-vs-im2col
            # split stays with the shape heuristic (tune.conv_mode=None).
            d = decide_gemm(m, kdim, o, a_bits, leaf.bits,
                            backends=lib_only, mode="cost", cache=cache,
                            device=device)
            return attach_conv(leaf, TuneDecision(backend=d.backend),
                               mat=d)
        *_, k, n = leaf.codes.shape
        m, be = m_hint, backends
        if moe_m_hint is not None and _is_expert_path(path):
            m, be = moe_m_hint, lib_only
        d = decide_gemm(m, k, n, a_bits, leaf.bits, backends=be, mode=mode,
                        cache=cache, measure=measure, device=device)
        return attach(leaf, d)

    return _map_packed(visit, tree)


# ---------------------------------------------------------------------------
# The on-disk tuning cache
# ---------------------------------------------------------------------------

_FIELDS = tuple(f.name for f in dataclasses.fields(TuneDecision))


def _decision_to(d: TuneDecision) -> dict:
    return {f: getattr(d, f) for f in _FIELDS}


def _decision_from(blob: dict) -> TuneDecision:
    kw = {f: blob[f] for f in _FIELDS if f in blob}
    if not isinstance(kw.get("backend"), str):
        raise ValueError(f"bad cached decision {blob!r}")
    return TuneDecision(**kw)


class TuningCache:
    """Persisted autotune decisions with fail-safe loading.

    The file format carries a schema ``VERSION``, the :func:`code_version`
    of the kernels that produced the entries, and the decisions keyed by
    :func:`gemm_key`/:func:`conv_key` strings (which bake in shape,
    precision, backend set and device kind). Any load problem (corrupt
    JSON, truncation, stale versions, unreadable entries) degrades to an
    empty in-memory cache with a single RuntimeWarning: decisions fall
    back to fresh cost-model picks, are memoized at once (one computation
    per key per process, no retune storm), and the next save heals the
    file. ``path=None`` is a process-local memo.
    """

    VERSION = 1

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: dict = {}
        self._warned = False
        if path:
            self._load()

    # -- robust IO ----------------------------------------------------------

    def _warn(self, msg: str):
        if not self._warned:
            warnings.warn(f"tuning cache {self.path!r}: {msg}; "
                          "falling back to cost-model picks",
                          RuntimeWarning, stacklevel=3)
            self._warned = True

    def _load(self):
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as fh:
                blob = json.load(fh)
            if blob.get("version") != self.VERSION:
                raise ValueError(f"schema version {blob.get('version')!r} "
                                 f"!= {self.VERSION}")
            if blob.get("code_version") != code_version():
                raise ValueError(
                    f"stale code_version {blob.get('code_version')!r}")
            self.entries = {k: self._entry_from(v)
                            for k, v in blob["entries"].items()}
        except Exception as e:
            self.entries = {}
            self._warn(f"unusable ({e!r})")

    @staticmethod
    def _entry_from(v: dict) -> dict:
        if "pair" in v:      # conv entries hold (conv, mat) decision pairs
            pair = tuple(_decision_from(p) for p in v["pair"])
            return {"decision": pair, "mode": v.get("mode", "cost")}
        return {"decision": _decision_from(v["decision"]),
                "mode": v.get("mode", "cost")}

    @staticmethod
    def _entry_to(e: dict) -> dict:
        d = e["decision"]
        if isinstance(d, tuple):
            return {"pair": [_decision_to(x) for x in d], "mode": e["mode"]}
        return {"decision": _decision_to(d), "mode": e["mode"]}

    def save(self):
        if not self.path:
            return
        blob = {"version": self.VERSION, "code_version": code_version(),
                "entries": {k: self._entry_to(e)
                            for k, e in self.entries.items()}}
        try:
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as fh:
                json.dump(blob, fh, indent=1)
            os.replace(tmp, self.path)   # atomic: no truncated cache files
        except OSError as e:
            self._warn(f"unwritable ({e!r})")

    def reset(self):
        """Drop the in-memory state and re-read the backing file.

        The single-warning fallback memo (``_warned``) sticks for the life
        of the instance: once a corrupt file degraded the cache, later
        ``get``s silently serve the empty memo even after the file on disk
        is repaired. Engine teardown (``ServeEngine.close`` /
        ``VisionEngine.close``) calls this so a second deploy sharing the
        cache object reloads the repaired file instead of re-tuning from
        scratch behind a stale warning flag."""
        self.entries = {}
        self._warned = False
        if self.path:
            self._load()

    # -- decisions ----------------------------------------------------------

    def get(self, key: str):
        e = self.entries.get(key)
        return e["decision"] if e else None

    def put(self, key: str, decision, mode: str = "cost"):
        self.entries[key] = {"decision": decision, "mode": mode}
        self.save()

    def __len__(self) -> int:
        return len(self.entries)

    # -- snapshot round trip (a checkpoint manifest's extra dict) -----------

    def to_extra(self) -> dict:
        """JSON-clean payload for a checkpoint manifest's ``extra``."""
        return {"version": self.VERSION, "code_version": code_version(),
                "entries": {k: self._entry_to(e)
                            for k, e in self.entries.items()}}

    def merge_extra(self, extra: dict | None):
        """Merge a snapshot's decisions back (restore path). Version or
        code mismatches are dropped with the same single-warning fallback
        as a stale file: restored engines then re-tune from cost."""
        if not extra:
            return
        try:
            if extra.get("version") != self.VERSION:
                raise ValueError(f"schema version {extra.get('version')!r}")
            if extra.get("code_version") != code_version():
                raise ValueError("stale code_version")
            for k, v in extra["entries"].items():
                self.entries.setdefault(k, self._entry_from(v))
        except Exception as e:
            self._warn(f"snapshot entries unusable ({e!r})")
        else:
            self.save()


def as_cache(cache) -> TuningCache:
    """Coerce an engine's ``tuning_cache`` argument (path | TuningCache |
    None) into a TuningCache instance."""
    if isinstance(cache, TuningCache):
        return cache
    return TuningCache(cache)
