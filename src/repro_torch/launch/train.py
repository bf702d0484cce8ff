"""Training launcher for the port: ``python -m repro_torch.launch.train
--arch <id> [...]``.

Wires configs -> init on the device -> the resilient step loop
(checkpoint/restart, straggler detection) -> the metrics log, as the JAX
package's ``repro.launch.train`` does, on one device: the GPU unless
``--device cpu``. ``--production-mesh`` (data-parallel and FSDP
training) is refused until mesh training is ported.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --reduced --steps 200 --batch 8 --seq 256 [--device cpu]

``--pim`` trains every projection quantization-aware (``<8:8>`` fake
quantization with straight-through gradients; the backend, "int-direct"
as in the reference, is not read in training).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import disable_tf32
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import init as model_init
from repro_torch.models.lm.model import cast_params, torch_dtype
from repro_torch.serving.vision import resolve_device
from repro_torch.training.data import DataConfig, make_source
from repro_torch.training.fault_tolerance import FTConfig, run_resilient
from repro_torch.training.optimizer import (OptimizerConfig, init_opt_state,
                                            leaves)
from repro_torch.training.train_loop import make_train_step


def build(arch_id: str, reduced: bool, batch: int, seq: int, steps: int,
          lr: float, accum: int, production_mesh: bool, pim: bool = False,
          device="cuda"):
    """(cfg, params, opt_state, step, source, put) of a training run:
    random weights from seed 0 in the arch's dtype with float32 masters,
    AdamW warming up over a tenth of the steps (at most 100), and the
    synthetic data source of seed 0."""
    if production_mesh:
        raise NotImplementedError(
            "--production-mesh: mesh training (data parallel, FSDP, "
            "compressed gradients) is not ported yet (ROADMAP.md Queue 1, "
            "item 7)")
    device = resolve_device(device)
    arch = get_config(arch_id)
    cfg = arch.model.reduced() if reduced else arch.model
    if pim:
        from repro_torch.core.pim_layers import PIMQuantConfig

        cfg = dataclasses.replace(cfg,
                                  pim=PIMQuantConfig(backend="int-direct"))
    params = cast_params(
        model_init(cfg, torch.Generator(device=device).manual_seed(0),
                   device=device), torch_dtype(cfg.dtype))
    ocfg = OptimizerConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                           total_steps=steps)
    opt_state = init_opt_state(ocfg, params)
    source = make_source(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch))
    step = make_train_step(cfg, ocfg, accum=accum)

    def put(host_batch):
        return {k: torch.from_numpy(v).to(device)
                for k, v in host_batch.items()}

    return cfg, params, opt_state, step, source, put


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--pim", action="store_true",
                    help="train the projections quantization-aware (<8:8>)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' trains on the host)")
    args = ap.parse_args(argv)
    disable_tf32()

    cfg, params, opt_state, step, source, put = build(
        args.arch, args.reduced, args.batch, args.seq, args.steps, args.lr,
        args.accum, args.production_mesh, args.pim, args.device)

    print(f"arch={args.arch} reduced={args.reduced} device={args.device} "
          f"params={sum(p.numel() for p in leaves(params)):,}", flush=True)

    history = []

    def on_metrics(s, m):
        if s % args.log_every == 0:
            loss = float(m["loss"])
            history.append((s, loss))
            print(f"step {s:5d}  loss {loss:.4f}  gnorm "
                  f"{float(m['grad_norm']):.3f} lr {float(m['lr']):.2e}",
                  flush=True)

    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    t0 = time.time()
    params, opt_state, stats = run_resilient(
        step, params, opt_state, source, args.steps, ft,
        put_batch=put, on_metrics=on_metrics)
    dt = time.time() - t0
    print(f"done: {stats} in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    if len(history) >= 2:
        print(f"loss: first {history[0][1]:.4f} -> last {history[-1][1]:.4f}")
    return history


if __name__ == "__main__":
    main()
