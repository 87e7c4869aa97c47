"""Mamba (selective SSM) block on the ``selective_scan`` kernel.

Counterpart of ``mdhs_tpu/modules/mamba.py::MambaBlock`` (Mamba-1):
in_proj -> split (x, z) -> depthwise causal conv1d -> silu -> x_proj (dt, B,
C) -> dt_proj -> + dt_bias, softplus -> selective_scan -> gate by silu(z)
-> out_proj. Names follow ``mamba_ssm`` where it has one (``in_proj``,
``conv1d``, ``x_proj``, ``dt_proj``, ``A_log``, ``D``, ``out_proj``); the
time-step bias is ``dt_bias`` beside a bias-free ``dt_proj``, as in the JAX
module.

The projections and the convolution compute in the module's dtype; ``dt``
plus ``dt_bias``, the softplus, ``A = -exp(A_log)``, ``D`` and the scan are
float32 (``dt_bias``, ``A_log`` and ``D`` are float32 parameters in a
bf16 module too), as flax keeps them; the trainer keeps them float32 beside
its bf16 working copies. In training the scan's gradient is the associative
scan's VJP (``ops/_library.py``), as JAX's custom VJP; the block has no
dropout.

``VMambaBlock`` (``mdhs_tpu/modules/mamba.py:106-124``), the ``vmamba``
fusion's: a LayerNorm (``norm``), then the ``fwd`` block on the tokens and
the ``bwd`` block on them reversed along L (reversed back after), and
``tokens + 0.5 * (fwd + bwd)``; two scans a forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import selective_scan as _ss


class MambaBlock(nn.Module):
    float32_params = ("dt_bias", "A_log", "D")  # float32 in a bf16 module, and in the trainer's

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: int | None = None, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        d_inner = expand * d_model
        self.d_inner, self.d_state, self.d_conv = d_inner, d_state, d_conv
        self.dt_rank = dt_rank or max(1, math.ceil(d_model / 16))
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False, **f)
        # depthwise, causal: the input is left-padded by d_conv - 1 in forward
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner, bias=True, **f)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False, **f)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner, bias=False, **f)
        self.dt_bias = nn.Parameter(torch.zeros(d_inner, **f32))
        self.A_log = nn.Parameter(torch.zeros((d_inner, d_state), **f32))
        self.D = nn.Parameter(torch.ones(d_inner, **f32))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False, **f)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """u: (B, L, d_model) -> (B, L, d_model)."""
        x, z = self.in_proj(u).chunk(2, dim=-1)
        x = self.conv1d(F.pad(x.transpose(1, 2), (self.d_conv - 1, 0))).transpose(1, 2)
        x = F.silu(x)
        dt, Bm, Cm = self.x_proj(x).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(self.dt_proj(dt).float() + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())
        y = _ss.selective_scan(x.float().contiguous(), dt.contiguous(), A, Bm.float().contiguous(),
                               Cm.float().contiguous(), self.D.float())
        y = y.to(u.dtype) * F.silu(z)
        return self.out_proj(y)


class VMambaBlock(nn.Module):
    """``num_heads`` is kept for the configuration's sake and unused, as in JAX."""

    def __init__(self, dim: int, num_heads: int = 2, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(dim, eps=1e-5, **f)
        self.fwd = MambaBlock(dim, **f)
        self.bwd = MambaBlock(dim, **f)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, L, dim) -> (B, L, dim)."""
        h = self.norm(tokens)
        return tokens + 0.5 * (self.fwd(h) + self.bwd(h.flip(1)).flip(1))
