"""PyTorch + CUDA port of the NAND-SPIN bit-serial PIM reproduction.

The JAX package ``repro`` is the reference; this package imports nothing of
it (and no JAX) and keeps the reference's module names and layouts:

  core/        Eq. 2 quantization, bit-plane packing, prepacked weights,
               the Eq. 1 product and the pim_linear / pim_conv2d layers
  kernels/     hand-written CUDA kernels for sm_90a (H100) + plain versions
  models/cnn/  AlexNet, VGG19, ResNet-50 (functional init / prepack /
               apply) and their layer specs
  configs/     the paper's CNN benchmark configurations
  pim/         the NAND-SPIN architecture simulator (host arithmetic)
  serving/     VisionEngine: queued, power-of-two micro-batched inference
  launch/      ``python -m repro_torch.launch.serve --workload cnn``
  convert.py   carry a JAX parameter tree (as numpy) across
"""
import torch


def disable_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32 on the GPU.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits: that breaks the exact integer sums of the conv
    border correction and moves the float path away from the reference.
    The port's entry points call this.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
