"""ResNet backbones with torchvision state_dict names.

Counterpart of ``mdhs_tpu/models/resnet.py``: ResNet18/34 (BasicBlock) and
ResNet50 (Bottleneck, torch v1.5 stride placement), and ``ResNetClassifier``
(trunk + global mean pool + Linear head; the MIBF image branch is
``resnet50`` with a 768-d head). Names follow torchvision (``conv1``,
``bn1``, ``layer{i}.{j}.conv{k}``, ``downsample.0/1``, ``fc``) so the JAX
converters read this state_dict directly.

Convolutions pad symmetrically by k//2, as the JAX package does; they are
cuDNN's, in ``channels_last`` on the card. BatchNorm is ``models/norm.py``'s
(torch's, eps 1e-5, momentum 0.1); ``bn_stats_kernel=True`` makes every one
of them take training-mode statistics from the ``bn_stats`` kernel.
The JAX package's space-to-depth stem (``S2DStemConv``) is a TPU layout
trick computing the same dot products and is not ported.

The taps (``stem`` after the max-pool, ``layer1`` .. ``layer4``) are flax's
``perturb`` points (``mdhs_tpu/models/resnet.py:230-250``): given a
``perturbations`` dict, ``forward`` adds its zero tensor at each (``perturb``),
so that the gradient with respect to it is the activation's, which Grad-CAM
reads (``analysis/gradcam.py``). Without one no op is added.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .norm import BatchNorm2d

STAGE_SIZES = {
    "resnet18": [2, 2, 2, 2],
    "resnet34": [3, 4, 6, 3],
    "resnet50": [3, 4, 6, 3],
}


def _conv(cin: int, cout: int, k: int, stride: int = 1, **factory) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False, **factory)


def _bn(c: int, bn_stats_kernel: bool = False, **factory) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1, bn_stats_kernel=bn_stats_kernel, **factory)


def _downsample(cin: int, cout: int, stride: int, bn_stats_kernel: bool = False, **factory):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride, **factory), _bn(cout, bn_stats_kernel, **factory))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet18/34)."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1, bn_stats_kernel: bool = False,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.conv1 = _conv(cin, width, 3, stride, **f)
        self.bn1 = _bn(width, bn_stats_kernel, **f)
        self.conv2 = _conv(width, width, 3, **f)
        self.bn2 = _bn(width, bn_stats_kernel, **f)
        self.downsample = _downsample(cin, width, stride, bn_stats_kernel, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 block (ResNet50)."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1, bn_stats_kernel: bool = False,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.conv1 = _conv(cin, width, 1, **f)
        self.bn1 = _bn(width, bn_stats_kernel, **f)
        self.conv2 = _conv(width, width, 3, stride, **f)
        self.bn2 = _bn(width, bn_stats_kernel, **f)
        self.conv3 = _conv(width, width * 4, 1, **f)
        self.bn3 = _bn(width * 4, bn_stats_kernel, **f)
        self.downsample = _downsample(cin, width * 4, stride, bn_stats_kernel, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + residual)


BLOCK_CLS = {"resnet18": BasicBlock, "resnet34": BasicBlock, "resnet50": Bottleneck}


def perturb(perturbations: Optional[dict], name: str, x: torch.Tensor) -> torch.Tensor:
    """flax's ``Module.perturb``: ``x + perturbations[name]``, the entry made as
    zeros of x's shape and dtype requiring grad where the dict has none (a second
    pass of the same tower adds the same tensor, as flax reads one variable);
    ``x`` itself where ``perturbations`` is None."""
    if perturbations is None:
        return x
    p = perturbations.get(name)
    if p is None:
        p = perturbations[name] = torch.zeros_like(x, requires_grad=True)
    return x + p


class ResNet(nn.Module):
    """ResNet trunk. ``forward(x, perturbations=None)`` takes NCHW and returns the
    taps ``stem`` (after the max-pool) and ``layer1`` .. ``layer4``."""

    def __init__(self, backbone: str = "resnet18", bn_stats_kernel: bool = False, device=None, dtype=None):
        super().__init__()
        if backbone not in STAGE_SIZES:
            raise ValueError(f"Unsupported backbone: {backbone}")
        f = dict(device=device, dtype=dtype)
        self.conv1 = _conv(3, 64, 7, 2, **f)
        self.bn1 = _bn(64, bn_stats_kernel, **f)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        block = BLOCK_CLS[backbone]
        cin = 64
        for i, (n_blocks, width) in enumerate(zip(STAGE_SIZES[backbone], (64, 128, 256, 512))):
            blocks = []
            for j in range(n_blocks):
                blocks.append(block(cin, width, 2 if (i > 0 and j == 0) else 1, bn_stats_kernel, **f))
                cin = width * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.out_channels = cin

    def forward(self, x: torch.Tensor, perturbations: Optional[dict] = None) -> dict[str, torch.Tensor]:
        x = perturb(perturbations, "stem", self.maxpool(torch.relu(self.bn1(self.conv1(x)))))
        taps = {"stem": x}
        for i in range(1, 5):
            x = perturb(perturbations, f"layer{i}", getattr(self, f"layer{i}")(x))
            taps[f"layer{i}"] = x
        return taps


class ResNetClassifier(ResNet):
    """ResNet trunk + global mean pool + Linear head; returns (logits, taps)."""

    def __init__(self, backbone: str = "resnet50", num_outputs: int = 768, bn_stats_kernel: bool = False,
                 device=None, dtype=None):
        super().__init__(backbone, bn_stats_kernel, device=device, dtype=dtype)
        self.fc = nn.Linear(self.out_channels, num_outputs, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor):
        taps = super().forward(x)
        return self.fc(taps["layer4"].mean(dim=(2, 3))), taps
