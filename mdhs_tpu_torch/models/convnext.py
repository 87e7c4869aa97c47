"""ConvNeXt trunk with HF ``ConvNextModel`` state_dict names, eval forward.

Counterpart of ``mdhs_tpu/models/convnext.py``: a 4x4 stride-4 stem and
LayerNorm; four stages of blocks (depthwise 7x7, LayerNorm eps 1e-6,
pointwise 4x, erf-GELU, pointwise, layer-scale, residual), stages 1-3 led
by a LayerNorm and a 2x2 stride-2 convolution. ``ConvNeXt`` returns the final
map NHWC, (B, H/32, W/32, C), as the JAX module does.

The activations stay channels-last between the convolutions: a block's
LayerNorm and its two pointwise ``nn.Linear``s act on the last dimension of
the contiguous NHWC tensor, and each convolution (cuDNN, ``channels_last``
on the card) takes its NCHW view, a ``permute`` with no copy. The
convolutions pad as flax's ``'SAME'``: the depthwise 7x7 by 3 on each side;
the stride-s patchify convolutions by ``s * ceil(n / s) - n``, the smaller
half first, which is nothing where s divides the size (224: 56, 28, 14, 7).

Names follow HF (``embeddings.patch_embeddings``, ``embeddings.layernorm``,
``encoder.stages.{i}.downsampling_layer.{0,1}``,
``encoder.stages.{i}.layers.{j}.{dwconv,layernorm,pwconv1,pwconv2,
layer_scale_parameter}``), which ``mdhs_tpu.core.convert.convert_convnext_hf``
reads. HF's final ``layernorm`` feeds only its pooler and is not here, as the
JAX converter drops it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gelu import exact_gelu

CONVNEXT_SPECS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}
LN_EPS = 1e-6


def register_convnext_variant(name: str, depths: Sequence[int], dims: Sequence[int]) -> None:
    """Register a custom (depths, dims) spec usable as ``variant``."""
    CONVNEXT_SPECS[name] = (tuple(depths), tuple(dims))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _patchify(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A k x k stride-k convolution of an NCHW tensor with flax's 'SAME' padding."""
    s = conv.stride[0]
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: W, then H
        total = -(-n // s) * s - n
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads) if any(pads) else x)


class ConvNextLayer(nn.Module):
    """One block on an NHWC tensor: x + gamma * pw2(gelu(pw1(ln(dw(x)))))."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.layer_scale_init = layer_scale_init
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, **f)
        self.layernorm = nn.LayerNorm(dim, eps=LN_EPS, **f)
        self.pwconv1 = nn.Linear(dim, 4 * dim, **f)
        self.pwconv2 = nn.Linear(4 * dim, dim, **f)
        self.layer_scale_parameter = nn.Parameter(torch.full((dim,), layer_scale_init, **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _nhwc(self.dwconv(_nchw(x)))
        h = self.pwconv2(exact_gelu(self.pwconv1(self.layernorm(h))))
        return x + self.layer_scale_parameter * h


class ConvNextStage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, downsample: bool, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.downsampling_layer = nn.ModuleList([nn.LayerNorm(cin, eps=LN_EPS, **f),
                                                 nn.Conv2d(cin, dim, 2, 2, **f)]) if downsample else None
        self.layers = nn.ModuleList(ConvNextLayer(dim, **f) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsampling_layer is not None:
            norm, conv = self.downsampling_layer
            x = _nhwc(_patchify(conv, _nchw(norm(x))))
        for layer in self.layers:
            x = layer(x)
        return x


class ConvNextEmbeddings(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.patch_embeddings = nn.Conv2d(3, dim, 4, 4, device=device, dtype=dtype)
        self.layernorm = nn.LayerNorm(dim, eps=LN_EPS, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layernorm(_nhwc(_patchify(self.patch_embeddings, x)))


class ConvNextStages(nn.Module):
    def __init__(self, depths: Sequence[int], dims: Sequence[int], device=None, dtype=None):
        super().__init__()
        cins = (dims[0],) + tuple(dims[:-1])
        self.stages = nn.ModuleList(ConvNextStage(cin, dim, depth, i > 0, device=device, dtype=dtype)
                                    for i, (cin, depth, dim) in enumerate(zip(cins, depths, dims)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in self.stages:
            x = stage(x)
        return x


class ConvNeXt(nn.Module):
    """ConvNeXt trunk. ``forward(x)`` takes NCHW images and returns the final
    NHWC feature map (no pooling, no head)."""

    def __init__(self, variant: str = "base", device=None, dtype=None):
        super().__init__()
        if variant not in CONVNEXT_SPECS:
            raise ValueError(f"unknown ConvNeXt variant {variant!r}; have {sorted(CONVNEXT_SPECS)}")
        self.variant = variant
        depths, dims = CONVNEXT_SPECS[variant]
        self.out_channels = dims[-1]
        self.embeddings = ConvNextEmbeddings(dims[0], device=device, dtype=dtype)
        self.encoder = ConvNextStages(depths, dims, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.embeddings.patch_embeddings.weight.dtype)
        return self.encoder(self.embeddings(x))


class ConvNeXtEncoder(nn.Module):
    """Headless ConvNeXt, global mean pool, then ``Linear(C, output_dim)``:
    ``mdhs_tpu/models/convnext.py::ConvNeXtEncoder`` (``backbone``,
    ``projection``)."""

    def __init__(self, output_dim: int = 768, variant: str = "large", device=None, dtype=None):
        super().__init__()
        self.backbone = ConvNeXt(variant, device=device, dtype=dtype)
        self.projection = nn.Linear(self.backbone.out_channels, output_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.backbone(x).mean(dim=(1, 2)))


def create_convnext_encoder(output_dim: int = 768, model_variant: str = "large", device=None, dtype=None,
                            **_kwargs) -> ConvNeXtEncoder:
    """``create_convnext_encoder`` of the JAX package: ``model_variant`` with or
    without its ``convnext_`` prefix; other keywords (pretrained, paths) are
    the weight loader's, not the module's."""
    variant = model_variant.replace("convnext_", "")
    if variant not in CONVNEXT_SPECS:
        raise ValueError(f"unknown ConvNeXt variant {model_variant!r}; have {sorted(CONVNEXT_SPECS)}")
    return ConvNeXtEncoder(output_dim, variant, device=device, dtype=dtype)
