"""Kolmogorov-Arnold Network layers (efficient-KAN) and the grouped KAN.

Counterpart of ``mdhs_tpu/modules/kan.py``: ``make_grid``, ``KANLinear``
(``silu(x) @ Wb^T + Bases(x) @ (Ws * scaler)^T`` through the ``kan_forward``
kernel), the ``KAN`` stack, the adaptive re-gridding ``kan_update_grid``
and ``GroupKANLinear``. Names follow efficient-KAN
(``base_weight``, ``spline_weight``, ``spline_scaler``, the ``grid``
buffer), which ``mdhs_tpu.core.convert._convert_kan_bank`` reads.

The layer computes in float32 whatever the module's dtype: its weights,
scaler and ``grid`` are float32 (in bf16 the knots -1 + 0.4 k would move, and
every basis with them), and only its output is cast to the module's dtype,
as the JAX layer does. The spline scaler is standalone (the JAX default, the
only form the repo builds). The regularization loss has no caller in the
repo and is not ported.

``kan_update_grid`` (``kan.py:183-239``) runs on the host in numpy, as in
JAX, between steps: the grid moves toward the captured inputs and the
spline weights are refit by a batched pseudo-inverse so that the layer's
function is kept.

``GroupKANLinear`` (``kan.py:242-290``) is the baseline ``kan`` head's layer:
the channels in each of ``num_groups`` groups share one learnable activation
``act_base * act(x) + sum_j act_coeff_j B_j(x)`` on one grid over (-4, 4)
(8 intervals, order 3), then dropout and a Linear ``linear``. ``act_coeff``
and ``act_base`` are float32 in a bf16 module, and the activation is
computed in float32 and cast to the module's dtype before the dropout, as
flax's float32 parameters in a bf16 module are; ``gelu`` is flax's default,
the tanh approximation. Plain tensor ops: no TPU kernel computes it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kan_spline as _ks
from ..ops.kan_spline import b_splines

__all__ = ["GroupKANLinear", "KAN", "KANLinear", "b_splines", "kan_update_grid", "make_grid"]


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


def _np_b_splines(x: np.ndarray, grid: np.ndarray, spline_order: int) -> np.ndarray:
    """``b_splines`` in numpy float32 (``mdhs_tpu/modules/kan.py::_np_b_splines``)."""
    x = np.asarray(x, np.float32)[..., None]
    g = np.asarray(grid, np.float32)[None]
    bases = ((x >= g[..., :-1]) & (x < g[..., 1:])).astype(np.float32)
    for k in range(1, spline_order + 1):
        left = (x - g[..., : -(k + 1)]) / (g[..., k:-1] - g[..., : -(k + 1)])
        right = (g[..., k + 1:] - x) / (g[..., k + 1:] - g[..., 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


def kan_update_grid(x: np.ndarray, grid: np.ndarray, spline_weight: np.ndarray, spline_scaler: np.ndarray | None,
                    *, grid_size: int, spline_order: int, grid_eps: float = 0.02,
                    margin: float = 0.01) -> tuple[np.ndarray, np.ndarray]:
    """One layer's re-grid on the host, ``mdhs_tpu/modules/kan.py::kan_update_grid``'s
    math on arrays: x (batch, in) the layer's captured inputs, grid (in, G + 2K + 1),
    spline_weight (out, in, G + K), the standalone scaler (out, in) or None. Returns
    (new spline_weight, new grid), float32: the grid a mix (``grid_eps``) of a
    uniform one over the inputs' range widened by ``margin`` and their quantiles,
    the weights the batched pseudo-inverse fit of the old splines' values on it."""
    grid = np.asarray(grid, np.float32)
    spline_w = np.asarray(spline_weight, np.float32)
    scaler = None if spline_scaler is None else np.asarray(spline_scaler, np.float32)
    x = np.asarray(x, np.float32).reshape(-1, grid.shape[0])
    batch = x.shape[0]
    splines = _np_b_splines(x, grid, spline_order)
    coeff = spline_w * (scaler[..., None] if scaler is not None else 1.0)
    unreduced = np.einsum("bic,oic->bio", splines, coeff)

    x_sorted = np.sort(x, axis=0)
    idx = np.linspace(0, batch - 1, grid_size + 1).astype(np.int32)
    grid_adaptive = x_sorted[idx]
    step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / grid_size
    grid_uniform = np.arange(grid_size + 1, dtype=np.float32)[:, None] * step + x_sorted[0] - margin
    new_core = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive
    lo = new_core[:1] - step * np.arange(spline_order, 0, -1, dtype=np.float32)[:, None]
    hi = new_core[-1:] + step * np.arange(1, spline_order + 1, dtype=np.float32)[:, None]
    new_grid = np.concatenate([lo, new_core, hi], axis=0).T

    A = _np_b_splines(x, new_grid, spline_order).transpose(1, 0, 2)
    sol = np.linalg.pinv(A) @ unreduced.transpose(1, 0, 2)
    new_coeff = sol.transpose(2, 0, 1)
    if scaler is not None:
        new_coeff = new_coeff / np.where(np.abs(scaler[..., None]) < 1e-8, 1.0, scaler[..., None])
    return new_coeff.astype(np.float32), new_grid.astype(np.float32)


_ACTIVATIONS = {"gelu": lambda v: F.gelu(v, approximate="tanh"), "silu": F.silu, "relu": F.relu,
                "identity": lambda v: v}


class GroupKANLinear(nn.Module):
    """Grouped KAN linear: a learnable activation a group of channels, then ``linear``."""

    def __init__(self, in_features: int, out_features: int, num_groups: int = 8, act_mode: str = "gelu",
                 drop: float = 0.0, grid_size: int = 8, spline_order: int = 3, grid_range=(-4.0, 4.0),
                 device=None, dtype=None):
        super().__init__()
        if in_features % num_groups != 0:
            raise ValueError("num_groups must divide in_features")
        if act_mode not in _ACTIVATIONS:
            raise KeyError(f"unknown act_mode {act_mode!r}")
        f32 = dict(device=device, dtype=torch.float32)
        self.in_features, self.out_features, self.num_groups = in_features, out_features, num_groups
        self.act_mode, self.grid_size, self.spline_order = act_mode, grid_size, spline_order
        # the shared 1-D grid: a constant of the JAX module, not a variable, so kept out of the state dict
        self.register_buffer("grid", make_grid(1, grid_size, spline_order, grid_range, device)[0], persistent=False)
        self.act_coeff = nn.Parameter(torch.empty((num_groups, grid_size + spline_order), **f32))
        self.act_base = nn.Parameter(torch.ones(num_groups, **f32))
        self.drop = nn.Dropout(drop)
        self.linear = nn.Linear(in_features, out_features, device=device, dtype=dtype)

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        """phi (batch, in), float32: each channel's group activation."""
        x2 = x.reshape(-1, self.in_features).float()
        bases = b_splines(x2, self.grid.expand(self.in_features, -1), self.spline_order)
        per = self.in_features // self.num_groups
        coeff = self.act_coeff.repeat_interleave(per, dim=0)
        base = self.act_base.repeat_interleave(per, dim=0)
        return base[None] * _ACTIVATIONS[self.act_mode](x2) + torch.einsum("bic,ic->bi", bases, coeff)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        phi = self.drop(self.activation(x).to(self.linear.weight.dtype))
        return self.linear(phi).reshape(*x.shape[:-1], self.out_features)
