"""Attention modules, counterparts of ``mdhs_tpu/modules/attention.py``.

- ``MultiHeadAttention``: the baseline fusions' attention, with
  ``nn.MultiheadAttention``'s parameter names, which
  ``mdhs_tpu.core.convert.convert_torch_mha`` reads: ``in_proj_weight`` (3E,
  E) where the keys and values are E wide, else ``q_proj_weight``,
  ``k_proj_weight`` (E, kdim) and ``v_proj_weight`` (E, vdim) (the JAX module
  infers those widths from its inputs); ``in_proj_bias`` (3E) and
  ``out_proj`` in both. Scores are divided by
  sqrt(head_dim) in the module's dtype, then the -1e9 key-padding bias is
  added and the softmax taken in float32, as the JAX module does.
- ``JointKVCrossAttention``: MIBF-Net's "IBFA" attention: Q from stream x,
  K and V the concatenation of projections of x and y, scaled by
  sqrt(head_dim), softmax in float32. Linear names follow the reference
  (``toQ_x``, ``toK_x``, ``toV_x``, ``toK_y``, ``toV_y``, ``to_out``), which
  ``mdhs_tpu.core.convert.convert_mibf_full`` reads.
- ``ConvCrossAttention2D``: ConNexT's cross-attention over NHWC maps: Q from
  map x, K and V from map y by 1x1 convolutions (``query_conv``,
  ``key_conv``, ``value_conv``, the names ``convert_connext_full`` reads),
  one head over the channels, the softmax in float32 and unscaled, as the
  reference's raw dot-product softmax. A 1x1 convolution of a channels-last
  map is a product on its last dimension, so each runs as ``F.linear`` with
  the convolution's weight.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


class MultiHeadAttention(nn.Module):
    """Separate q/k/v projections, packed as (3E, E) where ``kdim`` and
    ``vdim`` (the key and value widths, E by default) are E; a key padding
    mask (B, Lk) with 1 = valid, 0 = pad; in training, dropout on the
    attention probabilities (``dropout``, the JAX module's)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, kdim: Optional[int] = None,
                 vdim: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        f = dict(device=device, dtype=dtype)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.kdim, self.vdim = kdim or embed_dim, vdim or embed_dim
        self.dropout = nn.Dropout(dropout)
        if self.kdim == self.vdim == embed_dim:
            self.in_proj_weight = nn.Parameter(torch.empty((3 * embed_dim, embed_dim), **f))
        else:
            self.q_proj_weight = nn.Parameter(torch.empty((embed_dim, embed_dim), **f))
            self.k_proj_weight = nn.Parameter(torch.empty((embed_dim, self.kdim), **f))
            self.v_proj_weight = nn.Parameter(torch.empty((embed_dim, self.vdim), **f))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, **f))
        for name, w in self.named_parameters():  # nn.MultiheadAttention's default init, not torch.empty's bits
            if name.endswith("proj_weight"):
                nn.init.xavier_uniform_(w)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **f)
        # sqrt(head_dim) in the module's dtype, made once: a tensor made from a Python
        # number inside forward is a synchronous host-to-device copy on the card, and
        # dividing by a Python number runs there as a product with its reciprocal
        self.register_buffer("head_scale", torch.tensor((embed_dim // num_heads) ** 0.5, **f), persistent=False)

    def projection_weights(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The q, k and v projections' (E, width) weights."""
        if hasattr(self, "in_proj_weight"):
            return self.in_proj_weight.chunk(3)
        return self.q_proj_weight, self.k_proj_weight, self.v_proj_weight

    def forward(self, query, key, value, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        E, h = self.embed_dim, self.num_heads
        D = E // h
        b = self.in_proj_bias.chunk(3)
        q, k, v = (F.linear(t, w, b[i]) for i, (t, w) in enumerate(zip((query, key, value), self.projection_weights())))

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], h, D).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        scores = ((q @ k.transpose(-1, -2)) / self.head_scale.to(q.dtype)).float()
        if key_padding_mask is not None:
            scores = scores + ((1.0 - key_padding_mask.float()) * NEG_INF)[:, None, None, :]
        probs = self.dropout(torch.softmax(scores, dim=-1).to(q.dtype))
        ctx = (probs @ v).transpose(1, 2).reshape(query.shape[0], query.shape[1], E)
        return self.out_proj(ctx)


class JointKVCrossAttention(nn.Module):
    """``x_dim`` and ``y_dim``, the widths of the two streams, default to ``dim``
    (the flax module's Dense layers take any input width)."""

    def __init__(self, dim: int, num_heads: int = 1, x_dim: Optional[int] = None, y_dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim must be divisible by num_heads")
        f = dict(device=device, dtype=dtype)
        x_dim, y_dim = x_dim or dim, y_dim or dim
        self.dim, self.num_heads = dim, num_heads
        self.toQ_x = nn.Linear(x_dim, dim, **f)
        self.toK_x = nn.Linear(x_dim, dim, **f)
        self.toV_x = nn.Linear(x_dim, dim, **f)
        self.toK_y = nn.Linear(y_dim, dim, **f)
        self.toV_y = nn.Linear(y_dim, dim, **f)
        self.to_out = nn.Linear(dim, dim, **f)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x: (B, Lx, x_dim) queries; y: (B, Ly, y_dim). Returns (B, Lx, dim)."""
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


class ConvCrossAttention2D(nn.Module):
    """``x_dim`` and ``y_dim``, the channels of the two maps, default to ``dim``."""

    def __init__(self, dim: int, x_dim: Optional[int] = None, y_dim: Optional[int] = None, device=None,
                 dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.query_conv = nn.Conv2d(x_dim or dim, dim, 1, **f)
        self.key_conv = nn.Conv2d(y_dim or dim, dim, 1, **f)
        self.value_conv = nn.Conv2d(y_dim or dim, dim, 1, **f)

    @staticmethod
    def conv1x1(conv: nn.Conv2d, t: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H * W, C) through the 1x1 convolution."""
        return F.linear(t.reshape(t.shape[0], -1, t.shape[-1]), conv.weight.flatten(1), conv.bias)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x: (B, Hx, Wx, C) queries; y: (B, Hy, Wy, C). Returns x's shape."""
        q, k, v = self.conv1x1(self.query_conv, x), self.conv1x1(self.key_conv, y), self.conv1x1(self.value_conv, y)
        probs = torch.softmax((q @ k.transpose(1, 2)).float(), dim=-1).to(q.dtype)
        return (probs @ v).reshape(*x.shape[:3], -1)
