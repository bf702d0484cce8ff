"""Train-step factory: loss -> grad -> AdamW, with microbatch accumulation
(the JAX package's ``training.train_loop``).

``make_train_step(model_cfg, opt_cfg, accum)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``. The
gradient is taken by ``torch.autograd.grad`` with respect to detached
aliases of the param leaves, so the caller's tensors never carry a graph;
the optimizer then updates them in place (:func:`.optimizer.
apply_updates`). With ``accum`` > 1 the batch splits into ``accum``
microbatches, one backward each, whose gradients are summed in float32
buffers (a bf16 gradient would lose what the reference's float32
accumulator keeps), so peak activation memory is one microbatch's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import loss_fn
from repro_torch.models.lm.config import ModelConfig

from .checkpoint import _unflatten
from .optimizer import OptimizerConfig, apply_updates, leaves


def _split_microbatches(batch: dict, accum: int) -> list:
    """(B, ...) -> ``accum`` batches of (B / accum, ...), in row order."""
    per = next(iter(batch.values())).shape[0] // accum
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            for i in range(accum)]


def _on_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def value_and_grad(loss, params, batch):
    """(loss value, gradient tree) of ``loss(params, batch)``. A leaf the
    loss does not reach gets a zero gradient, as in JAX."""
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    val = loss(_unflatten(params, iter(live)), batch)
    grads = torch.autograd.grad(val, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return val.detach(), _unflatten(params, iter(grads))


def make_loss_fn(model_cfg: ModelConfig):
    def _loss(params, batch):
        return loss_fn(params, model_cfg, batch, train=True)
    return _loss


def make_train_step(model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    accum: int = 1, compress_grads=None):
    """Returns step(params, opt_state, batch). ``batch`` holds numpy arrays
    or tensors (moved to the params' device); ``compress_grads`` maps the
    gradient tree before the update."""
    loss = make_loss_fn(model_cfg)

    def step(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = _on_device(batch, device)
        if accum > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                   for p in leaves(params)]
            total = torch.zeros((), dtype=torch.float32, device=device)
            for mb in _split_microbatches(batch, accum):
                val, g = value_and_grad(loss, params, mb)
                for a, gi in zip(acc, leaves(g)):
                    a.add_(gi)
                total = total + val
                del g
            n = torch.full((), float(accum), dtype=torch.float32,
                           device=device)
            grads = _unflatten(params, (a.div_(n) for a in acc))
            loss_val = total / n
        else:
            loss_val, grads = value_and_grad(loss, params, batch)

        if compress_grads is not None:
            grads = compress_grads(grads)

        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        metrics["loss"] = loss_val
        return params, opt_state, metrics

    return step


__all__ = ["make_loss_fn", "make_train_step", "value_and_grad"]
