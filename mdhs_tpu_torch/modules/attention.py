"""MIBF-Net "IBFA" attention.

Counterpart of ``mdhs_tpu/modules/attention.py::JointKVCrossAttention``:
Q from stream x, K and V the concatenation of projections of x and y,
scaled by sqrt(head_dim), softmax in float32. Linear names follow the
reference (``toQ_x``, ``toK_x``, ``toV_x``, ``toK_y``, ``toV_y``,
``to_out``), which ``mdhs_tpu.core.convert.convert_mibf_full`` reads.
"""

from __future__ import annotations

import torch
from torch import nn


class JointKVCrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 1, device=None, dtype=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim must be divisible by num_heads")
        f = dict(device=device, dtype=dtype)
        self.dim, self.num_heads = dim, num_heads
        self.toQ_x = nn.Linear(dim, dim, **f)
        self.toK_x = nn.Linear(dim, dim, **f)
        self.toV_x = nn.Linear(dim, dim, **f)
        self.toK_y = nn.Linear(dim, dim, **f)
        self.toV_y = nn.Linear(dim, dim, **f)
        self.to_out = nn.Linear(dim, dim, **f)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x: (B, Lx, dim) queries; y: (B, Ly, dim). Returns (B, Lx, dim)."""
        h, D = self.num_heads, self.dim // self.num_heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], h, D).transpose(1, 2)

        q = split(self.toQ_x(x))
        k = torch.cat([split(self.toK_x(x)), split(self.toK_y(y))], dim=2)
        v = torch.cat([split(self.toV_x(x)), split(self.toV_y(y))], dim=2)
        scores = (q @ k.transpose(-1, -2)).float() / D**0.5
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = (probs @ v).transpose(1, 2).reshape(x.shape[0], x.shape[1], self.dim)
        return self.to_out(ctx)
