"""BatchNorm of the ResNet towers, with the option of taking training-mode
statistics from the ``bn_stats`` kernel.

Counterpart of ``mdhs_tpu/models/norm.py::TorchBatchNorm``, which is flax's
BatchNorm made to follow torch: biased variance to normalise, unbiased
(Bessel-corrected) variance into ``running_var``, momentum 0.1, eps 1e-5.
Here that is ``nn.BatchNorm2d`` itself, and its state_dict keys
(``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``) are the ones ``mdhs_tpu.core.convert`` reads.

``bn_stats_kernel=True`` takes the per-channel mean and biased variance of a
training-mode forward from ``ops/bn_stats.py::bn_stats`` (the CUDA kernel on
the card, its plain version on the CPU) and normalises as the JAX module does
(``mul = rsqrt(var + eps) * weight``, ``y = (x - mean) * mul + bias`` in the
input's dtype). It is off by default, as ``MDHS_BN_STATS_KERNEL`` is in the
JAX package; off, and in eval mode, the module is exactly torch's BatchNorm
(cuDNN on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.bn_stats import bn_stats


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 bn_stats_kernel: bool = False, device=None, dtype=None):
        super().__init__(num_features, eps=eps, momentum=momentum, device=device, dtype=dtype)
        self.bn_stats_kernel = bool(bn_stats_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.bn_stats_kernel):
            return super().forward(x)
        C = x.shape[1]
        mean, var = bn_stats(x.permute(0, 2, 3, 1))  # channels-last rows (N*H*W, C)
        n = x.numel() // C
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_((var * (n / max(n - 1, 1))).to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        dt = x.dtype
        shape = (1, C, 1, 1)
        mul = torch.rsqrt(var.to(dt) + self.eps) * self.weight.to(dt)
        return (x - mean.to(dt).view(shape)) * mul.view(shape) + self.bias.to(dt).view(shape)
