"""Fusion strategies of the baseline family.

Counterpart of ``mdhs_tpu/modules/fusion.py`` for ``multiscale`` (per-scale
text cross-attention on ResNet layer2/3/4 tokens, the mean of the three
pools) and ``mamba`` (image tokens plus the projected pooled text through a
Mamba block, mean pool). Every fusion takes (image tokens, text tokens,
text mask) and returns a (B, hidden_dim) feature; the image tokens are
(B, N, H) or the {layer2, layer3, layer4} dict. Names follow the reference
torch modules (``cross_l{2,3,4}.{txt_proj,attn,norm}``; ``txt_proj``,
``mamba``), which ``mdhs_tpu.core.convert`` reads. In training, the
multiscale fusion's attention drops its probabilities at ``dropout`` (the
model's clamped dropout, as in JAX); the Mamba fusion has no dropout. The
other fusion types raise ``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import MultiHeadAttention
from .mamba import MambaBlock

SCALES = ("layer2", "layer3", "layer4")


def pool_text(text_tokens: torch.Tensor, mode: str) -> torch.Tensor:
    """CLS or mean pooling."""
    if mode == "mean":
        return text_tokens.mean(dim=1)
    return text_tokens[:, 0, :]


def pool_image(image_tokens) -> torch.Tensor:
    """Mean over tokens; a dict gives the average of its per-scale means."""
    if isinstance(image_tokens, dict):
        p2, p3, p4 = (image_tokens[k].mean(dim=1) for k in SCALES)
        return (p2 + p3 + p4) / 3.0
    return image_tokens.mean(dim=1)


class CrossAttentionBlock(nn.Module):
    """LayerNorm(img + MHA(img, txt_proj(text), txt_proj(text), mask))."""

    def __init__(self, text_dim: int, hidden_dim: int, num_heads: int = 4, dropout: float = 0.0, device=None,
                 dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.txt_proj = nn.Linear(text_dim, hidden_dim, **f)
        self.attn = MultiHeadAttention(hidden_dim, num_heads, dropout, **f)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-5, **f)

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        txt = self.txt_proj(txt_tokens)
        return self.norm(img_tokens + self.attn(img_tokens, txt, txt, key_padding_mask=txt_mask))


class MultiScaleFusion(nn.Module):
    def __init__(self, text_dim: int, hidden_dim: int, num_heads: int = 4, dropout: float = 0.0, device=None,
                 dtype=None):
        super().__init__()
        for s in (2, 3, 4):
            setattr(self, f"cross_l{s}", CrossAttentionBlock(text_dim, hidden_dim, num_heads, dropout,
                                                             device=device, dtype=dtype))

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        if not isinstance(img_tokens, dict):
            img_tokens = dict.fromkeys(SCALES, img_tokens)
        p2, p3, p4 = (getattr(self, f"cross_l{k[-1]}")(img_tokens[k], txt_tokens, txt_mask).mean(dim=1)
                      for k in SCALES)
        return (p2 + p3 + p4) / 3.0


class SSMFusion(nn.Module):
    def __init__(self, text_dim: int, hidden_dim: int, text_pool: str = "cls", device=None, dtype=None):
        super().__init__()
        self.text_pool = text_pool
        self.txt_proj = nn.Linear(text_dim, hidden_dim, device=device, dtype=dtype)
        self.mamba = MambaBlock(hidden_dim, device=device, dtype=dtype)

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        if isinstance(img_tokens, dict):
            raise ValueError("SSMFusion expects single-scale image tokens.")
        txt = self.txt_proj(pool_text(txt_tokens, self.text_pool))
        return self.mamba(img_tokens + txt[:, None, :]).mean(dim=1)


NOT_PORTED = ("basic", "concat", "weighted_concat", "hadamard", "bilinear", "hierarchical", "vmamba")


def build_fusion(fusion_type: str, *, text_dim: int, hidden_dim: int, num_heads: int = 4, dropout: float = 0.0,
                 text_pool: str = "cls", device=None, dtype=None) -> nn.Module:
    f = dict(device=device, dtype=dtype)
    if fusion_type == "multiscale":
        return MultiScaleFusion(text_dim, hidden_dim, num_heads, dropout, **f)
    if fusion_type == "mamba":
        return SSMFusion(text_dim, hidden_dim, text_pool, **f)
    if fusion_type in NOT_PORTED:
        raise NotImplementedError(f"fusion_type={fusion_type!r} is not ported yet: ROADMAP Queue 1 item 10")
    raise KeyError(f"unknown fusion_type {fusion_type!r}")
