"""AdamW with warmup-cosine schedule and global-norm clipping, from scratch
(the JAX package's ``training.optimizer``; ``torch.optim`` is not used).

The state is ``{"m", "v", "step"}`` plus ``"master"``: trees of float32
tensors shaped like the params (a stacked scan leaf is one leaf), and a
0-d int32 step. ``master`` keeps float32 copies when params train in bf16
(mixed precision); ``keep_master=False`` drops it for pure-float32
training.

:func:`apply_updates` writes the new values into the state's and the
params' own tensors, a slice of rows at a time: a full-width model has no
room for a second copy of its 16 bytes a parameter of state. The
arithmetic is the reference's, element by element.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .checkpoint import _flatten, _unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    keep_master: bool = True


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device: a tensor operand, since
    CUDA divides by a Python number as a multiply by its reciprocal."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr (float32)."""
    step = step.to(torch.float32)
    warm = step / _f32(max(cfg.warmup_steps, 1), step)
    t = (step - cfg.warmup_steps) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), step)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _map(fn, tree):
    return _unflatten(tree, iter([fn(x) for x in leaves(tree)]))


def leaves(tree) -> list:
    """The tensors of a tree, dict keys sorted (the JAX package's order)."""
    return [x for _, x in _flatten(tree)]


def init_opt_state(cfg: OptimizerConfig, params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    state = {"m": _map(zeros, params), "v": _map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.keep_master:
        # A copy even of a float32 param, which the update writes in place.
        state["master"] = _map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


_NO_DECAY = frozenset({"scale", "bias", "lam", "b_a", "b_i", "w0", "u",
                       "ln_scale", "mu", "bq", "bk", "bv", "gate"})


def _decay_mask(name: str) -> bool:
    """Weight decay only on matrices (skip norms, biases, scalars): decided
    by the leaf's last dict key."""
    return name not in _NO_DECAY


def _named(tree, name=""):
    """(last dict key, leaf) pairs of a tree, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _named(v, name)]
    return [(name, tree)]


# Elements updated at a time: the update's float32 temporaries stay a few
# hundred MB even for a stacked (reps, K, N) leaf of a full-width model.
_SLICE_ELEMS = 1 << 26


def _row_slices(t: torch.Tensor):
    """Slices along dim 0 of at most ``_SLICE_ELEMS`` elements each."""
    if t.dim() == 0:
        return [slice(None)]
    rows = max(1, _SLICE_ELEMS // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step. Returns (params, state, metrics) with
    ``metrics = {"grad_norm", "lr"}`` (0-d float32 tensors).

    The params and the state are updated in place and returned; ``grads``
    (a tree like the params, of any float dtype) is only read."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-9), 1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)

    masters = state.get("master", params)
    named = _named(params)
    for (name, p), g, m, v, master in zip(
            named, leaves(grads), leaves(state["m"]), leaves(state["v"]),
            leaves(masters)):
        decay = _decay_mask(name)
        for sl in _row_slices(p):
            # The reference's expressions, evaluated in place where an
            # operand is not read again (the same roundings, fewer
            # temporaries): m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
            # u = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd master);
            # master = master - lr u.
            gi = g[sl].to(torch.float32) * scale
            m[sl].mul_(b1).add_(gi * (1 - b1))
            v[sl].mul_(b2).add_((gi * (1 - b2)).mul_(gi))
            u = m[sl] / bc1
            u.div_((v[sl] / bc2).sqrt_().add_(cfg.eps))
            base = master[sl]
            if decay:
                u.add_(base.to(torch.float32) * cfg.weight_decay)
            u.mul_(lr)
            if base.dtype == torch.float32:
                base.sub_(u)                 # the master (or a float32 p)
                if p is not master:
                    p[sl].copy_(base)
            else:                            # bf16 params, no masters
                p[sl].copy_(base.to(torch.float32) - u)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["OptimizerConfig", "apply_updates", "global_norm",
           "init_opt_state", "leaves", "schedule"]
