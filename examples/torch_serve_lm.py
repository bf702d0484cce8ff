"""Batched serving example of the PyTorch port: continuous batching with
slot recycling (the twin of examples/serve_lm.py).

Submits more requests than decode slots; the engine prefills into freed
slots while other sequences keep decoding (no global drain).

  PYTHONPATH=src python examples/torch_serve_lm.py                # GPU
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

One device: mesh serving comes in a later slice of the port.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import init as model_init
from repro_torch.models.lm.model import cast_params, torch_dtype
from repro_torch.serving import Request, SamplerConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-0.6b").model.reduced()
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = cast_params(model_init(cfg, gen, device=args.device),
                         torch_dtype(cfg.dtype))
    eng = ServeEngine(cfg, params, max_batch=4, max_len=96,
                      sampler=SamplerConfig(temperature=0.8, top_k=40),
                      device=args.device)
    rng = np.random.default_rng(7)
    n_req = 10
    t0 = time.time()
    for rid in range(n_req):
        L = int(rng.integers(4, 24))
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab, size=L).astype(np.int32),
                           max_new_tokens=int(rng.integers(8, 24))))
    done = eng.run()
    dt = time.time() - t0
    total = sum(len(c.tokens) for c in done)
    for c in sorted(done, key=lambda c: c.rid)[:4]:
        print(f"req {c.rid}: generated {len(c.tokens)} tokens: {c.tokens[:10]}")
    print(f"\n{len(done)}/{n_req} requests complete, {total} new tokens "
          f"in {dt:.1f}s ({total/dt:.1f} tok/s) with 4 decode slots")
    eng.close()


if __name__ == "__main__":
    main()
