"""Fusion strategies of the baseline family: all nine of
``mdhs_tpu/modules/fusion.py``.

Every fusion takes (image tokens, text tokens, text mask) and returns a (B,
hidden_dim) feature; the image tokens are (B, N, H) or the {layer2, layer3,
layer4} dict. ``fusion_type`` and the state-dict keys under ``fusion.``:

  basic            a pre-norm block: self-attention, cross-attention to the
                   text tokens (their mask a -1e9 key bias), FF (x4,
                   erf-GELU), mean pool: ``transformer_block.{norm1, attn1,
                   norm2, attn2, norm3, ff.0, ff.3}``
  multiscale       per-scale text cross-attention on layer2/3/4, the mean of
                   the three pools: ``cross_l{2,3,4}.{txt_proj, attn, norm}``
  concat           pooled image ++ pooled text -> Linear: ``proj``
  weighted_concat  each side times sigmoid of a float32 scalar first:
                   ``proj``, ``w_img``, ``w_txt``
  hadamard         img_proj(img) * txt_proj(txt) -> LayerNorm:
                   ``img_proj``, ``txt_proj``, ``norm``
  bilinear         rank-128 product -> out_proj -> LayerNorm: the same and
                   ``out_proj``
  hierarchical     layer2/3/4 each cross-attending to its depth-matched BERT
                   hidden state, the pools mixed by a float32 softmax of
                   ``scale_weights``: ``cross_l{2,3,4}.*``, ``scale_weights``
  mamba            image tokens plus the projected pooled text through a
                   Mamba block, mean pool: ``txt_proj``, ``mamba.*``
  vmamba           projected to 32, plus the projected pooled text, a
                   bidirectional Mamba block, out_proj, mean pool:
                   ``txt_proj``, ``in_proj``, ``out_proj``,
                   ``vmamba.{norm, fwd.*, bwd.*}``

The names are the reference torch modules' where ``mdhs_tpu.core.convert``
reads them (every fusion but ``hierarchical``, ``mamba`` and ``vmamba``),
else the JAX tree's, with Mamba's in mamba_ssm's. In training, the
attention fusions (``basic``, ``multiscale``, ``hierarchical``) drop their
attention probabilities at ``dropout`` (the model's clamped dropout, as in
JAX), and ``basic`` its FF after the GELU; the others have no dropout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.gelu import exact_gelu
from .attention import MultiHeadAttention
from .mamba import MambaBlock, VMambaBlock

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


def _scales(img_tokens) -> dict:
    return img_tokens if isinstance(img_tokens, dict) else dict.fromkeys(SCALES, img_tokens)


class GELU(nn.Module):
    """``exact_gelu`` as a module, the reference FF's ``nn.GELU``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return exact_gelu(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int, dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **f)
        self.attn1 = MultiHeadAttention(dim, num_heads, dropout, **f)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **f)
        self.attn2 = MultiHeadAttention(dim, num_heads, dropout, kdim=context_dim, vdim=context_dim, **f)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5, **f)
        self.ff = nn.Sequential(nn.Linear(dim, 4 * dim, **f), GELU(), nn.Dropout(dropout), nn.Linear(4 * dim, dim, **f))

    def forward(self, x, context, context_mask=None):
        h = self.norm1(x)
        x = x + self.attn1(h, h, h)
        h = self.norm2(x)
        x = x + self.attn2(h, context, context, key_padding_mask=context_mask)
        return x + self.ff(self.norm3(x))


class BasicFusion(nn.Module):
    def __init__(self, text_dim: int, hidden_dim: int, num_heads: int = 4, dropout: float = 0.0, device=None,
                 dtype=None):
        super().__init__()
        self.transformer_block = BasicTransformerBlock(hidden_dim, text_dim, num_heads, dropout, device=device,
                                                       dtype=dtype)

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        return self.transformer_block(img_tokens, txt_tokens, txt_mask).mean(dim=1)


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
        img_tokens = _scales(img_tokens)
        p2, p3, p4 = (getattr(self, f"cross_l{k[-1]}")(img_tokens[k], txt_tokens, txt_mask).mean(dim=1)
                      for k in SCALES)
        return (p2 + p3 + p4) / 3.0


class HierarchicalFusion(MultiScaleFusion):
    """Scale layer{s} cross-attends to BERT's hidden state ``text_layers[s - 2]``
    (index 0 the embeddings); the three pools are mixed by the softmax of
    ``scale_weights``, taken in float32 and cast to the pools' dtype."""

    float32_params = ("scale_weights",)

    def __init__(self, text_dim: int, hidden_dim: int, num_heads: int = 4, dropout: float = 0.0,
                 text_layers: Sequence[int] = (4, 8, 12), device=None, dtype=None):
        super().__init__(text_dim, hidden_dim, num_heads, dropout, device=device, dtype=dtype)
        self.text_layers = tuple(text_layers)
        self.scale_weights = nn.Parameter(torch.zeros(3, device=device, dtype=torch.float32))

    def forward(self, img_tokens, txt_tokens, txt_mask=None, text_hidden_states: Optional[Sequence] = None):
        img_tokens = _scales(img_tokens)
        if text_hidden_states is None:
            text_hidden_states = (txt_tokens,) * (max(self.text_layers) + 1)
        pooled = []
        for key, layer in zip(SCALES, self.text_layers):
            if layer >= len(text_hidden_states):
                raise ValueError(f"hierarchical fusion text_layers index {layer} out of range for "
                                 f"{len(text_hidden_states)} text hidden states")
            block = getattr(self, f"cross_l{key[-1]}")
            pooled.append(block(img_tokens[key], text_hidden_states[layer], txt_mask).mean(dim=1))
        w = torch.softmax(self.scale_weights.float(), dim=0).to(pooled[0].dtype)
        return w[0] * pooled[0] + w[1] * pooled[1] + w[2] * pooled[2]


class ConcatFusion(nn.Module):
    def __init__(self, text_dim: int, hidden_dim: int, text_pool: str = "cls", device=None, dtype=None):
        super().__init__()
        self.text_pool = text_pool
        self.proj = nn.Linear(hidden_dim + text_dim, hidden_dim, device=device, dtype=dtype)

    def pooled(self, img_tokens, txt_tokens):
        img = pool_image(img_tokens)
        return img, pool_text(txt_tokens, self.text_pool).to(img.dtype)

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        return self.proj(torch.cat(self.pooled(img_tokens, txt_tokens), dim=-1))


class WeightedConcatFusion(ConcatFusion):
    """Each side times the sigmoid of its float32 scalar, in float32 (as ``jnp``
    promotes a bf16 tensor times a float32 one), cast to ``proj``'s dtype."""

    float32_params = ("w_img", "w_txt")

    def __init__(self, text_dim: int, hidden_dim: int, text_pool: str = "cls", device=None, dtype=None):
        super().__init__(text_dim, hidden_dim, text_pool, device=device, dtype=dtype)
        self.w_img = nn.Parameter(torch.zeros(1, device=device, dtype=torch.float32))
        self.w_txt = nn.Parameter(torch.zeros(1, device=device, dtype=torch.float32))

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        img, txt = self.pooled(img_tokens, txt_tokens)
        fused = torch.cat([img.float() * torch.sigmoid(self.w_img.float()),
                           txt.float() * torch.sigmoid(self.w_txt.float())], dim=-1)
        return self.proj(fused.to(self.proj.weight.dtype))


class HadamardFusion(nn.Module):
    """LayerNorm(img_proj(img) * txt_proj(txt)) at ``rank``; with ``out_proj``
    (``bilinear``) the product is projected to hidden_dim before the norm."""

    def __init__(self, text_dim: int, hidden_dim: int, text_pool: str = "cls", rank: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.text_pool = text_pool
        width = rank or hidden_dim
        self.img_proj = nn.Linear(hidden_dim, width, **f)
        self.txt_proj = nn.Linear(text_dim, width, **f)
        if rank is not None:
            self.out_proj = nn.Linear(rank, hidden_dim, **f)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-5, **f)

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        fused = self.img_proj(pool_image(img_tokens)) * self.txt_proj(pool_text(txt_tokens, self.text_pool))
        if hasattr(self, "out_proj"):
            fused = self.out_proj(fused)
        return self.norm(fused)


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


class VMambaFusion(nn.Module):
    def __init__(self, text_dim: int, hidden_dim: int, text_pool: str = "cls", vmamba_dim: int = 32, device=None,
                 dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.text_pool = text_pool
        self.txt_proj = nn.Linear(text_dim, vmamba_dim, **f)
        self.in_proj = nn.Linear(hidden_dim, vmamba_dim, **f)
        self.vmamba = VMambaBlock(vmamba_dim, max(1, vmamba_dim // 16), **f)
        self.out_proj = nn.Linear(vmamba_dim, hidden_dim, **f)

    def forward(self, img_tokens, txt_tokens, txt_mask=None):
        if isinstance(img_tokens, dict):
            raise ValueError("VMambaFusion expects single-scale image tokens.")
        txt = self.txt_proj(pool_text(txt_tokens, self.text_pool))
        tokens = self.vmamba(self.in_proj(img_tokens) + txt[:, None, :])
        return self.out_proj(tokens).mean(dim=1)


BILINEAR_RANK = 128


def build_fusion(fusion_type: str, *, text_dim: int, hidden_dim: int, num_heads: int = 4, dropout: float = 0.0,
                 text_pool: str = "cls", text_layers: Optional[Sequence[int]] = None, device=None,
                 dtype=None) -> nn.Module:
    """The fusion ``fusion_type`` names; ``num_heads`` and ``dropout`` reach the
    attention fusions only, ``text_layers`` the hierarchical one, as in JAX."""
    f = dict(device=device, dtype=dtype)
    attn = (text_dim, hidden_dim, num_heads, dropout)
    if fusion_type == "basic":
        return BasicFusion(*attn, **f)
    if fusion_type == "multiscale":
        return MultiScaleFusion(*attn, **f)
    if fusion_type == "hierarchical":
        return HierarchicalFusion(*attn, **({"text_layers": text_layers} if text_layers is not None else {}), **f)
    if fusion_type == "concat":
        return ConcatFusion(text_dim, hidden_dim, text_pool, **f)
    if fusion_type == "weighted_concat":
        return WeightedConcatFusion(text_dim, hidden_dim, text_pool, **f)
    if fusion_type == "hadamard":
        return HadamardFusion(text_dim, hidden_dim, text_pool, **f)
    if fusion_type == "bilinear":
        return HadamardFusion(text_dim, hidden_dim, text_pool, rank=BILINEAR_RANK, **f)
    if fusion_type == "mamba":
        return SSMFusion(text_dim, hidden_dim, text_pool, **f)
    if fusion_type == "vmamba":
        return VMambaFusion(text_dim, hidden_dim, text_pool, **f)
    raise KeyError(f"unknown fusion_type {fusion_type!r}")
