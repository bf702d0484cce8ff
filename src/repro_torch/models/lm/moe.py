"""Mixture-of-experts FFN with sort-based token dispatch (grok-1,
phi3.5-moe), on one device.

The JAX package's ``moe_ffn`` with one token group (``g = 1``: every token
of the call routes together and shares one capacity), in four steps:

  1. ``route``: router logits in float32, softmax, top-k (lower expert
     first on ties, as ``jax.lax.top_k``) and renormalised gates; the
     balance and z losses; the T*k assignments sorted by expert
     (``argsort(stable=True)``), each one's rank within its expert from a
     ``searchsorted`` of the sorted ids, and its slot ``expert * cap +
     rank``, or the trash slot ``E * cap`` past capacity (dropped);
  2. ``dispatch``: the tokens scattered into an (E, cap, d) buffer;
  3. ``experts``: the batched expert FFN over the buffer; every capacity
     row is computed, empty ones too, as the reference does;
  4. ``combine``: each kept assignment's row gathered back, weighted by its
     gate and added onto its token (two addends onto zero with top-2, the
     same sum in any order).

The expert FFN has two executions sharing the rest, so capacity and drops
are the same in both:

  * float: raw (E, d, f) weights, one batched product a stage in the model
    dtype (the reference's einsums, outside any kernel);
  * packed: weights prepacked as expert banks (an (E, K, N)
    :class:`~repro_torch.core.packed.PackedWeight`, ``prepack_params``).
    The activations quantize once, before dispatch, so dispatch moves int32
    codes; each stage is one Eq. 1 product over the whole bank
    (``core.bitserial.int_matmul_prepacked_bank``: on ``cuda`` one launch
    of kernel 2's batched entry) and the Eq. 2 affine correction with each
    expert's own ``wq``; the hidden activations re-calibrate per expert on
    ``h * filled`` (unfilled rows zeroed) before the second stage.

Rows of the trash slot and unfilled rows are never gathered: the combine
masks with ``torch.where`` (an empty expert's rows may hold anything).

The mesh and its sharding constraints (expert and tensor parallelism, the
token groups) come with mesh serving (``ROADMAP.md`` Queue 1, item 7).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitserial
from repro_torch.core.packed import PackedWeight
from repro_torch.core.quantize import (affine_correction, calibrate_minmax,
                                       quantize)

from .config import ModelConfig
from .mlp import _ACTS
from .rwkv6 import randn


def init_moe(cfg: ModelConfig, generator, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": randn(generator, (d, e), d**-0.5, device),
         "w_in": randn(generator, (e, d, f), d**-0.5, device),
         "w_out": randn(generator, (e, f, d), f**-0.5, device)}
    if cfg.act.endswith("gated"):
        p["w_gate"] = randn(generator, (e, d, f), d**-0.5, device)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    mc = cfg.moe
    c = int(tokens * mc.top_k / mc.n_experts * mc.capacity_factor)
    return max(c + (-c) % 8, 8)  # sublane-align


class Routing(NamedTuple):
    """One call's routing. Assignments are the T*k (token, choice) pairs
    in expert-sorted order: ``order`` (T*k,) their flat (token * k +
    choice) index, ``slot`` their row of the (E*cap + 1, d) buffer,
    ``keep`` whether they fit their expert's capacity ``cap``,
    ``src_token`` their token; ``gates`` (T, k) float32."""
    gates: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    src_token: torch.Tensor
    cap: int
    aux: dict


def route(p, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """x (T, d) -> the routing and the aux dict (``loss``: balance + z
    loss; ``drop``: the fraction of assignments dropped at capacity;
    ``layers``: 1, so a sum over layers can be averaged)."""
    mc = cfg.moe
    t = x.shape[0]
    k, e = mc.top_k, mc.n_experts
    cap = _capacity(t, cfg)
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # A stable descending sort keeps the lower expert first on ties.
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- losses ----
    me = probs.mean(0)                                       # (E,)
    counts = torch.nn.functional.one_hot(expert_ids, e).sum((0, 1))
    ce = counts.to(torch.float32) / (t * k)
    aux = mc.aux_loss * e * (me * ce).sum()
    z = mc.router_z_loss * (torch.logsumexp(logits, dim=-1) ** 2).mean()

    # ---- sort dispatch ----
    flat_expert = expert_ids.reshape(t * k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(e, device=x.device), right=False)
    rank = torch.arange(t * k, device=x.device) - group_start[sorted_expert]
    keep = rank < cap
    slot = torch.where(keep, sorted_expert * cap + rank, e * cap)
    drop = (1.0 - keep.to(torch.float32)).mean()
    return Routing(gate_vals, order, slot, keep, order // k, cap,
                   {"loss": aux + z, "drop": drop,
                    "layers": torch.ones((), device=x.device)})


def _scatter(vals: torch.Tensor, r: Routing, e: int) -> torch.Tensor:
    """Rows ``vals`` (T*k, ...) into their slots of an (E, cap, ...)
    buffer of zeros. Dropped rows all land on the trash row (in no set
    order), which is cut off."""
    buf = vals.new_zeros((e * r.cap + 1, *vals.shape[1:]))
    buf.index_put_((r.slot,), vals)
    return buf[:-1].reshape(e, r.cap, *vals.shape[1:])


def dispatch(p, cfg: ModelConfig, x: torch.Tensor, r: Routing) -> dict:
    """The experts' inputs: the float buffer (E, cap, d) in x's dtype, or,
    with packed banks, the activation codes (quantized once, over all
    tokens, before the scatter), their quantization and the occupancy
    mask (E, cap, 1)."""
    e = cfg.moe.n_experts
    if not isinstance(p["w_in"], PackedWeight):
        return {"buf": _scatter(x[r.src_token], r, e)}
    a_bits = cfg.pim.a_bits if cfg.pim is not None else 8
    aq = calibrate_minmax(x.to(torch.float32), a_bits)
    qa = _scatter(quantize(x, aq)[r.src_token], r, e)
    filled = _scatter(torch.ones((r.slot.shape[0], 1), dtype=torch.float32,
                                 device=x.device), r, e)
    return {"qa": qa, "aq": aq, "filled": filled}


def experts(p, cfg: ModelConfig, disp: dict, dtype) -> torch.Tensor:
    """The batched expert FFN over the dispatched buffer -> (E, cap, d) in
    ``dtype``."""
    act = _ACTS[cfg.act.split("_")[0]]
    if "buf" in disp:
        buf = disp["buf"]
        h = torch.bmm(buf, p["w_in"].to(dtype))
        if "w_gate" in p:
            h = act(torch.bmm(buf, p["w_gate"].to(dtype))) * h
        else:
            h = act(h)
        return torch.bmm(h, p["w_out"].to(dtype))
    pim = cfg.pim
    a_bits = pim.a_bits if pim is not None else 8
    backend = pim.backend if pim is not None else "int-direct"

    def stage(qa, w, aq):
        """Eq. 1 over the bank and the affine correction, each expert with
        its own ``wq`` (and, for per-expert ``aq``, its own)."""
        prod = bitserial.int_matmul_prepacked_bank(qa, w, a_bits, backend)
        sa = qa.sum(-1, keepdim=True)
        return affine_correction(prod, sa, w.col_sums[:, None],
                                 qa.shape[-1], aq, w.wq.per_expert())

    qa, aq = disp["qa"], disp["aq"]
    h = stage(qa, p["w_in"], aq)                             # (E, cap, f)
    h = act(stage(qa, p["w_gate"], aq)) * h if "w_gate" in p else act(h)
    # Unfilled rows zeroed, so they cannot widen an expert's calibration.
    h = h * disp["filled"]
    hq = calibrate_minmax(h, a_bits, per_expert=True)
    return stage(quantize(h, hq.per_expert()), p["w_out"],
                 hq.per_expert()).to(dtype)


def combine(yb: torch.Tensor, r: Routing, t: int) -> torch.Tensor:
    """Each kept assignment's expert output, times its gate, added onto its
    token -> (T, d)."""
    e, cap, d = yb.shape
    rows = yb.reshape(e * cap, d)[r.slot.clamp_max(e * cap - 1)]
    rows = torch.where(r.keep[:, None], rows, torch.zeros((), dtype=yb.dtype,
                                                          device=yb.device))
    w = r.gates.reshape(-1)[r.order][:, None].to(yb.dtype)
    return yb.new_zeros((t, d)).index_add_(0, r.src_token, rows * w)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, train: bool = False):
    """x (B, S, d) -> (out (B, S, d), aux dict) (``route``'s aux).

    ``train`` is taken for the reference's signature and changes nothing:
    float expert banks contract in float (no fake quantization), as in the
    JAX package, and only a prepacked bank runs Eq. 1."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    r = route(p, cfg, x2)
    yb = experts(p, cfg, dispatch(p, cfg, x2, r), x.dtype)
    return combine(yb, r, b * s).reshape(b, s, d), r.aux


__all__ = ["Routing", "combine", "dispatch", "experts", "init_moe",
           "moe_ffn", "route"]
