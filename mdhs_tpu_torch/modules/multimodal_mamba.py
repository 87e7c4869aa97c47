"""Multimodal Mamba fusion: the text CLS vector, the image map's tokens and the
LLM's first and last hidden states as one sequence through KAN attention and
Mamba.

Counterpart of ``mdhs_tpu/modules/multimodal_mamba.py``:

- ``KANMultiheadAttention``: multi-head attention whose q, k and v
  projections are each a one-layer ``KAN((D, D))`` (``q_proj``, ``k_proj``,
  ``v_proj``) through the ``kan_forward`` kernel, the scores in float32 over
  sqrt(head_dim), -1e9 where ``mask`` is 0, a float32 softmax cast to the
  module's dtype, and ``out_proj``. The attention core is plain tensor ops,
  as JAX computes it outside any Pallas kernel.
- ``MultimodalMamba``: ``proj_text``, ``proj_img``, ``proj_first`` and
  ``proj_last`` to ``proj_dim`` (256), the sequence ``[text, image tokens,
  first, last]`` (52 tokens for a 7 x 7 map) plus the sinusoidal positional
  table in the sequence's dtype; with KAN attention (ConNexT's) ``attn``,
  ``norm1`` over attn + seq, ``mamba`` (``MambaBlock(d_model=256,
  d_state=128)``, one ``selective_scan`` a forward) and ``norm2`` over
  mamba + seq; without it, mamba + seq.
- ``SimpleFusion``: the three pooled modalities, each projected, stacked.

Names follow the JAX tree (no reference checkpoint of the fusion exists):
``proj_*``, ``attn.{q,k,v}_proj.layers.0.*`` (``modules/kan.py``'s KAN),
``attn.out_proj``, ``norm1``, ``mamba.*`` (``modules/mamba.py``), ``norm2``.
The attention's dropout is 0 in every configuration, as in JAX, and is not
built.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .kan import KAN
from .mamba import MambaBlock
from .sequence import sinusoidal_pe


class KANMultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 8, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        f = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.q_proj = KAN((embed_dim, embed_dim), **f)
        self.k_proj = KAN((embed_dim, embed_dim), **f)
        self.v_proj = KAN((embed_dim, embed_dim), **f)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **f)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, L, D); ``mask`` broadcast to the (B, heads, L, L) scores, 0 where a key is hidden."""
        B, L, D = x.shape
        h = self.num_heads
        q, k, v = (p(x).reshape(B, L, h, D // h) for p in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / ((D // h) ** 0.5)
        if mask is not None:
            scores = scores.masked_fill(mask == 0, -1e9)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, D))


class MultimodalMamba(nn.Module):
    def __init__(self, text_dim: int = 768, img_dim: int = 1568, hidden_dim: int = 3584, proj_dim: int = 256,
                 use_kan_attention: bool = False, num_heads: int = 4, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.proj_dim, self.use_kan_attention = proj_dim, use_kan_attention
        self.proj_text = nn.Linear(text_dim, proj_dim, **f)
        self.proj_img = nn.Linear(img_dim, proj_dim, **f)
        self.proj_first = nn.Linear(hidden_dim, proj_dim, **f)
        self.proj_last = nn.Linear(hidden_dim, proj_dim, **f)
        if use_kan_attention:
            self.attn = KANMultiheadAttention(proj_dim, num_heads, **f)
            self.norm1 = nn.LayerNorm(proj_dim, eps=1e-5, **f)
            self.norm2 = nn.LayerNorm(proj_dim, eps=1e-5, **f)
        self.mamba = MambaBlock(proj_dim, d_state=128, **f)

    def forward(self, text: torch.Tensor, img_tokens: torch.Tensor, first_hidden: torch.Tensor,
                last_hidden: torch.Tensor) -> torch.Tensor:
        """text (B, text_dim), img_tokens (B, N, img_dim), first / last_hidden (B,
        hidden_dim) -> (B, N + 3, proj_dim)."""
        seq = torch.cat([self.proj_text(text)[:, None], self.proj_img(img_tokens),
                         self.proj_first(first_hidden)[:, None], self.proj_last(last_hidden)[:, None]], dim=1)
        seq = seq + sinusoidal_pe(seq.shape[1], self.proj_dim, seq.device, seq.dtype)[None]
        if not self.use_kan_attention:
            return self.mamba(seq) + seq
        seq = self.norm1(self.attn(seq) + seq)
        return self.norm2(self.mamba(seq) + seq)


class SimpleFusion(nn.Module):
    """The mean image token, the text vector and the two hidden vectors, each
    projected: (B, 3, proj_dim) (``text_proj``, ``img_proj``, ``hidden_proj``)."""

    def __init__(self, text_dim: int, img_dim: int, hidden_dim: int, proj_dim: int = 256, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.text_proj = nn.Linear(text_dim, proj_dim, **f)
        self.img_proj = nn.Linear(img_dim, proj_dim, **f)
        self.hidden_proj = nn.Linear(2 * hidden_dim, proj_dim, **f)

    def forward(self, text_embedding, image_tokens, first_hidden, last_hidden) -> torch.Tensor:
        t = self.text_proj(text_embedding)
        i = self.img_proj(image_tokens.mean(dim=1))
        h = self.hidden_proj(torch.cat([first_hidden, last_hidden], dim=1))
        return torch.stack([t, i, h], dim=1)
