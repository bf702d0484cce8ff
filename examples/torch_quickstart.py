"""Quickstart of the PyTorch + CUDA port: the paper's technique in five
minutes, step for step as ``examples/quickstart.py``.

1. Run a quantized bit-serial matmul (Eq. 1) on all four backends and
   check they agree with the dense float product.
2. Run AlexNet inference with PIM-quantized layers.
3. Price ResNet50 inference on the NAND-SPIN architecture simulator.

  PYTHONPATH=src python examples/torch_quickstart.py                # GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # CPU

On a GPU the "cuda" and "popcount" backends launch the hand-written CUDA
kernels; ``--device cpu`` runs their plain PyTorch versions.
"""
import argparse

import torch

from repro_torch import disable_tf32
from repro_torch.core import BACKENDS, PIMQuantConfig, quantized_matmul
from repro_torch.models.cnn import alexnet
from repro_torch.models.cnn import layers as L
from repro_torch.pim.simulator import simulate_model
from repro_torch.serving.vision import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    gen = torch.Generator().manual_seed(0)

    # -- 1. Eq. 1: I*W = sum 2^(n+m) bitcount(AND(plane_n, plane_m)) --------
    a = torch.randn((4, 256), generator=gen).to(device)
    w = torch.randn((256, 8), generator=gen).to(device)
    dense = a @ w
    for backend in BACKENDS:
        y = quantized_matmul(a, w, a_bits=8, w_bits=8, backend=backend)
        err = float((y - dense).abs().max() / dense.abs().max())
        print(f"backend={backend:10s} max rel err vs dense fp32: {err:.4f}")

    # -- 2. AlexNet forward with PIM-quantized layers -----------------------
    cfg = PIMQuantConfig(w_bits=8, a_bits=8, backend="cuda")
    params = L.tree_to(alexnet.init(gen, image=64), device)
    x = torch.randn((2, 64, 64, 3), generator=gen).to(device)
    with torch.inference_mode():
        logits = alexnet.apply(params, x, cfg=cfg)
    print(f"\nAlexNet<8:8> logits shape {tuple(logits.shape)}, "
          f"finite={bool(logits.isfinite().all())}")

    # -- 3. Price ResNet50 on the NAND-SPIN simulator -----------------------
    r = simulate_model("resnet50")
    print(f"\nNAND-SPIN 64MB/128b: ResNet50 {r.fps:.1f} fps "
          f"(paper Table 3: 80.6), {r.energy * 1e3:.2f} mJ/frame")
    print("latency breakdown:", {k: round(v, 3) for k, v in
                                 r.latency_breakdown.items()})
    return r


if __name__ == "__main__":
    main()
