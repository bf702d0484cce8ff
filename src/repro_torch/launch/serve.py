"""Serving launcher for the port: LM generation and CNN inference.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
      --arch llama3.2-3b --requests 6 --max-new 16 \
      [--precision '<8:8>' --backend cuda] [--reduced --device cpu]

serves an LM architecture (the dense ``llama3.2-3b``, ``qwen3-0.6b``,
``qwen1.5-4b``, ``granite-3-2b``, ``rwkv6-3b``, the RG-LRU and
local-attention hybrid ``recurrentgemma-9b``, or the MoE
``phi3.5-moe-42b-a6.6b`` and ``grok-1-314b``, which do not fit one card at
their published sizes: serve them ``--reduced``; random weights from a
seed, the arch's dtype; with ``--precision '<W:I>'`` every projection and
expert bank runs the paper's bit-serial pipeline in float32) through the
continuous-batching ``ServeEngine``. The two archs fed by the stub
frontends, ``musicgen-large`` and ``llama-3.2-vision-90b``, are refused,
as the JAX package's launcher refuses them: they run through the model
functions ``prefill`` and ``decode_step``.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \
      --cnn-model resnet50 --image 224 --requests 16 --precision '<8:8>'

sends random images through the prepacked bit-serial conv path in
power-of-two micro-batch buckets; a warm run fills the prepack cache and
builds the kernels, the timed run then measures serving.

Both run on the GPU unless ``--device cpu``, and print the lines of
``repro.launch.serve`` for the same workload. ``--autotune cost|measure``
tunes every packed weight's backend and tiles (``repro_torch.pim.
autotune``); ``--tuning-cache PATH`` keeps the decisions across launches.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import disable_tf32
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import BACKENDS, PIMQuantConfig
from repro_torch.models.lm import model as lm
from repro_torch.serving import (MODEL_ZOO, Request, SamplerConfig,
                                 ServeEngine, VisionEngine, VisionRequest,
                                 parse_precision)
from repro_torch.serving.vision import resolve_device

CNN_MODELS = tuple(sorted(MODEL_ZOO))


def serve_cnn(args):
    """Vision workload: micro-batched CNN inference."""
    module = MODEL_ZOO[args.cnn_model]
    params = module.init(torch.Generator().manual_seed(0), image=args.image,
                         num_classes=args.classes)
    eng = VisionEngine({args.cnn_model: params}, backend=args.backend,
                       max_batch=args.max_batch, autotune=args.autotune,
                       tuning_cache=args.tuning_cache, device=args.device)
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal(
        (args.requests, args.image, args.image, 3)).astype(np.float32)
    args.precision = args.precision or "<8:8>"
    precision = None if parse_precision(args.precision) is None \
        else args.precision
    for _ in range(2):   # warm run, then the timed run
        for rid in range(args.requests):
            eng.submit(VisionRequest(rid=rid, image=imgs[rid],
                                     model=args.cnn_model,
                                     precision=precision))
        t0 = time.time()
        done = eng.run()
        dt = time.time() - t0
    for c in sorted(done, key=lambda c: c.rid)[:8]:
        print(f"req {c.rid}: top1={c.top1} (bucket {c.batch})")
    print(f"{len(done)} images in {dt:.2f}s ({len(done) / dt:.1f} img/s, "
          f"model={args.cnn_model}@{args.image}px, "
          f"precision={args.precision}, backend={args.backend})")


def serve_lm(args):
    """LM workload: continuous-batching generation through ServeEngine."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch).model
    cfg = cfg.reduced() if args.reduced else cfg
    if not cfg.embed_inputs or cfg.cross_attn_every:
        raise SystemExit("serve launcher drives token-in archs; "
                         "musicgen/vlm need frontend-stub drivers (see examples)")
    bits = parse_precision(args.precision)
    if bits is not None:
        cfg = dataclasses.replace(cfg, dtype="float32", pim=PIMQuantConfig(
            w_bits=bits[0], a_bits=bits[1], backend=args.backend))
    params = lm.cast_params(
        lm.init(cfg, torch.Generator(device=device).manual_seed(0),
                device=device), lm.torch_dtype(cfg.dtype))
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_len=args.max_len,
                      sampler=SamplerConfig(temperature=args.temperature),
                      autotune=args.autotune,
                      tuning_cache=args.tuning_cache, device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        L = int(rng.integers(4, 17))
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, size=L).astype(np.int32),
            max_new_tokens=args.max_new))
    done = eng.run()
    dt = time.time() - t0
    n_tok = sum(len(c.tokens) for c in done)
    for c in sorted(done, key=lambda c: c.rid):
        print(f"req {c.rid}: {len(c.tokens)} tokens -> {c.tokens[:8]}...")
    print(f"{len(done)} completions, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "cnn"), default="lm")
    ap.add_argument("--arch", choices=ARCH_IDS,
                    help="LM architecture (required for --workload lm)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cnn-model", choices=CNN_MODELS, default="resnet50")
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--precision", default=None,
                    help="'<W:I>' bit-widths, or 'float' for the fp path "
                         "(default: '<8:8>' for cnn, float for lm)")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="Eq. 1 backend: cuda and popcount run the CUDA "
                         "kernels, mxu-plane and int-direct a library "
                         "product")
    ap.add_argument("--autotune", default="off",
                    choices=("off", "cost", "measure"),
                    help="per-weight backend/tile autotuning at prepack "
                         "(repro_torch.pim.autotune): 'cost' ranks "
                         "candidates with the NAND-SPIN cost model, "
                         "'measure' refines the finalists by timing them")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="JSON tuning-cache file persisting autotune "
                         "decisions across launches (default: in memory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    disable_tf32()
    if args.workload == "cnn":
        serve_cnn(args)
        return
    if args.arch is None:
        raise SystemExit("--workload lm requires --arch")
    serve_lm(args)


if __name__ == "__main__":
    main()
