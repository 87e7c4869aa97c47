"""Seeded random initialisation from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter of ``model`` from ``generator``.

    Linear and conv weights are normal with std 1/sqrt(fan_in), the scale of
    flax's lecun-normal default that the JAX package initialises with; biases
    are zero; embeddings are normal with std 0.02 (BERT's initializer range);
    LayerNorm and BatchNorm are the identity (weight 1, bias 0, running mean
    0, running variance 1). Values are drawn on the generator's device in
    float32 and cast to each parameter's dtype and device.
    """

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return model
