"""The paper's benchmark CNNs (AlexNet / VGG19 / ResNet50) in PyTorch.

Each model exposes:
  init(generator, num_classes, image) -> param tree (dict of tensors)
  prepack(params, cfg)                -> same tree, weights packed once
  apply(params, x, cfg)               -> logits (cfg: PIMQuantConfig | None)
  layer_specs(batch, image)           -> list[GemmSpec] for the PIM simulator
"""
from . import alexnet, resnet, vgg
from .specs import GemmSpec, model_specs, total_macs

# The paper's three networks by the names the simulator and engine use.
MODELS = {"alexnet": alexnet, "resnet50": resnet, "vgg19": vgg}

__all__ = ["alexnet", "vgg", "resnet", "GemmSpec", "MODELS", "model_specs",
           "total_macs"]
