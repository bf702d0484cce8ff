"""The paper's benchmark CNNs in PyTorch (ResNet-50 so far).

Each model exposes:
  init(generator, num_classes, image) -> param tree (dict of tensors)
  prepack(params, cfg)                -> same tree, weights packed once
  apply(params, x, cfg)               -> logits (cfg: PIMQuantConfig | None)
"""
from . import resnet

__all__ = ["resnet"]
