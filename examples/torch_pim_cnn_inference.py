"""The paper's own pipeline end to end on the PyTorch + CUDA port, step for
step as ``examples/pim_cnn_inference.py``: quantized CNN inference through
the bit-serial path, then device-level pricing of the same network.

Sweeps <W:I> precision like Figs. 14-15 and reports (a) numerical accuracy
deltas of the bit-serial path vs fp32, (b) simulated fps/energy on the
NAND-SPIN architecture.

  PYTHONPATH=src python examples/torch_pim_cnn_inference.py         # GPU, 224 px
  PYTHONPATH=src python examples/torch_pim_cnn_inference.py --device cpu

The image defaults to 224 px on the GPU and 64 px on the CPU (the plain
versions of the kernels are slow at full resolution).
"""
import argparse

import torch

from repro_torch import disable_tf32
from repro_torch.core import PIMQuantConfig
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import resnet
from repro_torch.pim.simulator import simulate_model
from repro_torch.serving.vision import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    ap.add_argument("--image", type=int, default=None,
                    help="image size (default 224 on the GPU, 64 on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    image = args.image or (224 if device.type == "cuda" else 64)
    gen = torch.Generator().manual_seed(0)
    params = L.tree_to(resnet.init(gen, image=image), device)
    x = torch.randn((2, image, image, 3), generator=gen).to(device)

    rows = []
    with torch.inference_mode():
        ref = resnet.apply(params, x, cfg=None)  # fp32 reference
        print(f"{'W:I':8s} {'top1 agree':>10s} {'max|dlogit|':>12s} "
              f"{'sim fps':>8s} {'mJ/frame':>9s}")
        for bits in (2, 4, 8):
            cfg = PIMQuantConfig(w_bits=bits, a_bits=bits, backend="cuda")
            # Deployment mode: weights quantize+pack exactly once (the paper
            # programs subarrays once); apply() then only quantizes
            # activations.
            packed = resnet.prepack(params, cfg)
            y = resnet.apply(packed, x, cfg=cfg)
            agree = float((y.argmax(-1) == ref.argmax(-1)).float().mean())
            dmax = float((y - ref).abs().max())
            r = simulate_model("resnet50", ab=bits, wb=bits)
            rows.append((bits, agree, dmax, r))
            print(f"<{bits}:{bits}>   {agree:10.2f} {dmax:12.4f} "
                  f"{r.fps:8.1f} {r.energy * 1e3:9.2f}")

    print(f"\nResNet50 at {image} px on {device}. Lower precision -> higher "
          "simulated fps (fewer bit-plane pairs), at growing numerical "
          "deviation — the paper's Figs. 14-15 trade-off.")
    return rows


if __name__ == "__main__":
    main()
