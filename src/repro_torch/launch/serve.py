"""Serving launcher for the port: micro-batched CNN inference.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \
      --cnn-model resnet50 --image 224 --requests 16 --precision '<8:8>'

Random images (from a seed) go through the prepacked bit-serial conv path
in power-of-two micro-batch buckets, on the GPU unless ``--device cpu``.
A warm run fills the prepack cache and builds the kernels; the timed run
then measures serving. The lines printed are those of
``repro.launch.serve --workload cnn``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import BACKENDS
from repro_torch.serving import (MODEL_ZOO, VisionEngine, VisionRequest,
                                 parse_precision)

CNN_MODELS = tuple(sorted(MODEL_ZOO))


def serve_cnn(args):
    """Vision workload: micro-batched CNN inference."""
    module = MODEL_ZOO[args.cnn_model]
    params = module.init(torch.Generator().manual_seed(0), image=args.image,
                         num_classes=args.classes)
    eng = VisionEngine({args.cnn_model: params}, backend=args.backend,
                       max_batch=args.max_batch, device=args.device)
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal(
        (args.requests, args.image, args.image, 3)).astype(np.float32)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("cnn",), default="cnn")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cnn-model", choices=CNN_MODELS, default="resnet50")
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--precision", default="<8:8>",
                    help="'<W:I>' bit-widths, or 'float' for the fp path")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="Eq. 1 backend: cuda and popcount run the CUDA "
                         "kernels, mxu-plane and int-direct a library "
                         "product")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    serve_cnn(ap.parse_args(argv))


if __name__ == "__main__":
    main()
