"""Kolmogorov-Arnold Network layers (efficient-KAN), eval forward.

Counterpart of ``mdhs_tpu/modules/kan.py``: ``make_grid``, ``KANLinear``
(``silu(x) @ Wb^T + Bases(x) @ (Ws * scaler)^T`` through the ``kan_forward``
kernel) and the ``KAN`` stack. Names follow efficient-KAN
(``base_weight``, ``spline_weight``, ``spline_scaler``, the ``grid``
buffer), which ``mdhs_tpu.core.convert._convert_kan_bank`` reads.

The layer computes in float32 whatever the module's dtype: its weights,
scaler and ``grid`` are float32 (in bf16 the knots -1 + 0.4 k would move, and
every basis with them), and only its output is cast to the module's dtype,
as the JAX layer does. The spline scaler is standalone (the JAX default, the
only form the repo builds). The grid re-fit (``update_grid``), the regularization
loss and ``GroupKANLinear`` wait for the training path and the ``kan`` head
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import kan_spline as _ks
from ..ops.kan_spline import b_splines

__all__ = ["KAN", "KANLinear", "b_splines", "make_grid"]


def make_grid(in_features: int, grid_size: int, spline_order: int, grid_range=(-1.0, 1.0),
              device=None) -> torch.Tensor:
    """Uniform knots, (in, G + 2K + 1) float32, as the JAX ``make_grid``."""
    h = (grid_range[1] - grid_range[0]) / grid_size
    pts = torch.arange(-spline_order, grid_size + spline_order + 1, dtype=torch.float32, device=device)
    return (pts * h + grid_range[0])[None, :].repeat(in_features, 1)


class KANLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, grid_size: int = 5, spline_order: int = 3,
                 scale_noise: float = 0.1, scale_base: float = 1.0, scale_spline: float = 1.0,
                 grid_range=(-1.0, 1.0), device=None, dtype=None):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.in_features, self.out_features = in_features, out_features
        self.grid_size, self.spline_order, self.grid_range = grid_size, spline_order, tuple(grid_range)
        self.scale_noise, self.scale_base, self.scale_spline = scale_noise, scale_base, scale_spline
        self.out_dtype = dtype or torch.get_default_dtype()
        self.register_buffer("grid", make_grid(in_features, grid_size, spline_order, grid_range, device))
        self.base_weight = nn.Parameter(torch.empty((out_features, in_features), **f32))
        self.spline_weight = nn.Parameter(torch.empty((out_features, in_features, grid_size + spline_order), **f32))
        self.spline_scaler = nn.Parameter(torch.empty((out_features, in_features), **f32))

    def scaled_spline_weight(self) -> torch.Tensor:
        return self.spline_weight * self.spline_scaler[..., None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, self.in_features).float().contiguous()
        out = _ks.kan_forward(x2, self.grid, self.base_weight, self.scaled_spline_weight(), self.spline_order)
        return out.to(self.out_dtype).reshape(*x.shape[:-1], self.out_features)


class KAN(nn.Module):
    """Stack of KANLinear layers: ``layers.{i}``."""

    def __init__(self, layers_hidden: Sequence[int] = (768, 512, 256), grid_size: int = 5, spline_order: int = 3,
                 scale_noise: float = 0.1, scale_base: float = 1.0, scale_spline: float = 1.0,
                 device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            KANLinear(fin, fout, grid_size, spline_order, scale_noise, scale_base, scale_spline,
                      device=device, dtype=dtype)
            for fin, fout in zip(layers_hidden, layers_hidden[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
