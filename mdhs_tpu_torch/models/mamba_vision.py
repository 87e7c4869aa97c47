"""MambaVision, the hybrid Mamba + attention image backbone, with NVIDIA's
state_dict names.

Counterpart of ``mdhs_tpu/models/mamba_vision.py``:

- ``PatchEmbed``: two stride-2 3x3 convolutions without bias, each followed by
  BatchNorm (eps 1e-4) and ReLU (``patch_embed.conv_down.{0,1,3,4}``).
- Stages 1-2: ``ConvBlock``s, 3x3 convolution (with bias), BatchNorm (eps
  1e-5), tanh-GELU in the module's dtype, 3x3 convolution, BatchNorm,
  residual (``levels.{i}.blocks.{j}.{conv1,norm1,conv2,norm2}``); no zoo entry
  sets a convolution layer scale, so there is no ``gamma``.
- Stages 3-4: the map, NHWC, zero-padded at the bottom and right up to the
  stage's window, split into (B * windows, ws * ws, C) windows, run through
  ``Block``s, put back and cropped. The padded tokens go unmasked through the
  attention and the scan, as in JAX. At 224 the windows (14, 7) cover the
  map, so nothing is padded. A ``Block`` is LayerNorm (eps 1e-5), a mixer
  (``MambaVisionMixer`` or ``Attention``, both under ``mixer``), residual,
  LayerNorm, the MLP ``mlp.fc1`` / erf-GELU / ``mlp.fc2``, residual; with
  ``gamma_1`` / ``gamma_2`` on the two branches where the variant has a
  layer scale (B, L, L2, L3). The mixers come first in a stage and the
  attention blocks last (``transformer_block_indices``).
- ``MambaVisionMixer``: ``in_proj`` (no bias) into the halves x and z; each
  through its own SAME-padded depthwise conv1d without bias (``conv1d_x``,
  ``conv1d_z``) and silu; x through ``x_proj`` into (dt, B, C), dt through
  ``dt_proj`` as a float32 product with its bias, then the same bias added
  again before the softplus (the vendored forward passes it twice; pretrained
  weights were trained under it); the ``selective_scan`` kernel on x; the
  scan's output and z concatenated (z is not a gate here) into
  ``out_proj`` (no bias). ``dt_proj``, ``A_log`` and ``D`` are float32
  parameters in a bf16 module, as flax keeps them.
- ``Attention``: the packed ``qkv`` (with bias) as (B, N, 3, heads, head_dim),
  the scores in float32 over sqrt(head_dim), softmax, ``proj``. Head
  dims are 40 and 80 for T; plain tensor ops, as JAX computes them outside
  any Pallas kernel.
- ``levels.{i}.downsample.reduction.0``: a 3x3 stride-2 convolution without
  bias after stages 1-3; ``norm`` (BatchNorm2d) and ``head`` for
  ``classify``, built only where ``head=True`` (the encoder's tower has none,
  as flax creates them only when ``classify`` runs).

Images are NCHW; convolutions are cuDNN's (``channels_last`` on the card) and
BatchNorm is ``models/norm.py``'s, as in the port's ResNet. ``forward``
returns the taps ``stem``, ``layer1`` .. ``layer4`` (each stage's output
before its downsampling, NCHW), as the ResNet's, which the baseline's image
encoder reads; ``classify`` gives the logits. ``mdhs_tpu.core.convert.
convert_mamba_vision`` reads this module's ``state_dict()``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import selective_scan as _ss
from ..ops.gelu import exact_gelu
from .norm import BatchNorm2d
from .resnet import perturb

__all__ = ["MAMBA_VISION_SPECS", "Attention", "Block", "ConvBlock", "MambaVision", "MambaVisionMixer",
           "transformer_block_indices", "window_partition", "window_reverse"]

MAMBA_VISION_SPECS = {
    # dim, in_dim, depths, num_heads, window_size, layer_scale (token blocks)
    "T": dict(dim=80, in_dim=32, depths=(1, 3, 8, 4), heads=(2, 4, 8, 16),
              window=(8, 8, 14, 7), layer_scale=None),
    "T2": dict(dim=80, in_dim=32, depths=(1, 3, 11, 4), heads=(2, 4, 8, 16),
               window=(8, 8, 14, 7), layer_scale=None),
    "S": dict(dim=96, in_dim=64, depths=(3, 3, 7, 5), heads=(2, 4, 8, 16),
              window=(8, 8, 14, 7), layer_scale=None),
    "B": dict(dim=128, in_dim=64, depths=(3, 3, 10, 5), heads=(2, 4, 8, 16),
              window=(8, 8, 14, 7), layer_scale=1e-5),
    "L": dict(dim=196, in_dim=64, depths=(3, 3, 10, 5), heads=(4, 8, 16, 32),
              window=(8, 8, 14, 7), layer_scale=1e-5),
    "L2": dict(dim=196, in_dim=64, depths=(3, 3, 12, 5), heads=(4, 8, 16, 32),
               window=(8, 8, 14, 7), layer_scale=1e-5),
    "L2_512": dict(dim=196, in_dim=64, depths=(3, 3, 12, 5), heads=(4, 8, 16, 32),
                   window=(8, 8, 32, 16), layer_scale=1e-5),
    "L3": dict(dim=256, in_dim=64, depths=(3, 3, 20, 10), heads=(4, 8, 16, 32),
               window=(8, 8, 16, 8), layer_scale=1e-5),
    "L3_512": dict(dim=256, in_dim=64, depths=(3, 3, 20, 10), heads=(4, 8, 16, 32),
                   window=(8, 8, 32, 16), layer_scale=1e-5),
}


def spec_of(variant: str) -> dict:
    if variant not in MAMBA_VISION_SPECS:
        raise ValueError(f"unknown MambaVision variant {variant!r}: expected one of {sorted(MAMBA_VISION_SPECS)}")
    return MAMBA_VISION_SPECS[variant]


def stage_widths(variant: str) -> dict[str, int]:
    """The channels of the taps ``layer1`` .. ``layer4`` (T: 80, 160, 320, 640)."""
    dim = spec_of(variant)["dim"]
    return {f"layer{i + 1}": dim * 2 ** i for i in range(4)}


def transformer_block_indices(depth: int) -> range:
    """The attention blocks: the tail of each token stage."""
    return range(depth // 2 + 1, depth) if depth % 2 else range(depth // 2, depth)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws * ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B * windows, ws * ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class Float32Linear(nn.Linear):
    """A Linear whose weight and bias stay float32 in a bf16 module (and in the
    trainer), applied as a float32 product."""

    float32_params = ("weight", "bias")

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float(), None if self.bias is None else self.bias.float())


class PatchEmbed(nn.Module):
    def __init__(self, in_dim: int, dim: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.conv_down = nn.Sequential(
            nn.Conv2d(3, in_dim, 3, 2, 1, bias=False, **f), BatchNorm2d(in_dim, eps=1e-4, **f), nn.ReLU(),
            nn.Conv2d(in_dim, dim, 3, 2, 1, bias=False, **f), BatchNorm2d(dim, eps=1e-4, **f), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_down(x)


class ConvBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv2d(dim, dim, 3, 1, 1, **f)
        self.norm1 = BatchNorm2d(dim, eps=1e-5, **f)
        self.conv2 = nn.Conv2d(dim, dim, 3, 1, 1, **f)
        self.norm2 = BatchNorm2d(dim, eps=1e-5, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.norm1(self.conv1(x)), approximate="tanh")
        return x + self.norm2(self.conv2(h))


class MambaVisionMixer(nn.Module):
    float32_params = ("A_log", "D")

    def __init__(self, dim: int, d_state: int = 8, d_conv: int = 3, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        half = dim // 2
        self.half, self.d_state, self.d_conv = half, d_state, d_conv
        self.dt_rank = max(1, math.ceil(dim / 16))
        self.in_proj = nn.Linear(dim, dim, bias=False, **f)
        self.x_proj = nn.Linear(half, self.dt_rank + 2 * d_state, bias=False, **f)
        self.dt_proj = Float32Linear(self.dt_rank, half, device=device)
        self.conv1d_x = nn.Conv1d(half, half, d_conv, groups=half, bias=False, **f)
        self.conv1d_z = nn.Conv1d(half, half, d_conv, groups=half, bias=False, **f)
        self.A_log = nn.Parameter(torch.zeros((half, d_state), device=device, dtype=torch.float32))
        self.D = nn.Parameter(torch.ones(half, device=device, dtype=torch.float32))
        self.out_proj = nn.Linear(dim, dim, bias=False, **f)

    def _dwconv(self, conv: nn.Conv1d, v: torch.Tensor) -> torch.Tensor:
        """(B, L, half) -> (B, L, half): 'SAME'-padded depthwise, no bias."""
        lo = (self.d_conv - 1) // 2
        y = F.conv1d(F.pad(v.transpose(1, 2), (lo, self.d_conv - 1 - lo)), conv.weight, groups=self.half)
        return y.transpose(1, 2)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """u: (B, L, dim) -> (B, L, dim)."""
        x, z = self.in_proj(u).chunk(2, dim=-1)
        x = F.silu(self._dwconv(self.conv1d_x, x))
        z = F.silu(self._dwconv(self.conv1d_z, z))
        dt, Bm, Cm = self.x_proj(x).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(self.dt_proj(dt) + self.dt_proj.bias.float())  # the bias a second time
        A = -torch.exp(self.A_log.float())
        y = _ss.selective_scan(x.float().contiguous(), dt.contiguous(), A, Bm.float().contiguous(),
                               Cm.float().contiguous(), self.D.float())
        return self.out_proj(torch.cat([y.to(u.dtype), z], dim=-1))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, **f)
        self.proj = nn.Linear(dim, dim, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        q, k, v = self.qkv(x).reshape(B, N, 3, h, hd).unbind(2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (hd ** 0.5)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(exact_gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, use_attention: bool, mlp_ratio: float = 4.0,
                 layer_scale: Optional[float] = None, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **f)
        self.mixer = Attention(dim, num_heads, **f) if use_attention else MambaVisionMixer(dim, **f)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **f)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **f)
        self.layer_scale = layer_scale
        if layer_scale is not None:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(layer_scale), **f))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(layer_scale), **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mixer(self.norm1(x))
        x = x + (h if self.layer_scale is None else self.gamma_1.to(x.dtype) * h)
        h = self.mlp(self.norm2(x))
        return x + (h if self.layer_scale is None else self.gamma_2.to(x.dtype) * h)


class Downsample(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.reduction = nn.Sequential(nn.Conv2d(dim, 2 * dim, 3, 2, 1, bias=False, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(x)


class Level(nn.Module):
    """One stage: ``blocks`` and, after stages 1-3, ``downsample`` (applied by ``MambaVision``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, conv: bool, downsample: bool,
                 layer_scale: Optional[float], device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.conv, self.window = conv, window
        attn = set(transformer_block_indices(depth))
        self.blocks = nn.ModuleList(ConvBlock(dim, **f) if conv else
                                    Block(dim, num_heads, j in attn, layer_scale=layer_scale, **f)
                                    for j in range(depth))
        self.downsample = Downsample(dim, **f) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The stage's blocks on an NCHW map (the windows for a token stage)."""
        if self.conv:
            for blk in self.blocks:
                x = blk(x)
            return x
        _, _, H, W = x.shape
        ws = self.window  # padded up to the window, never shrunk
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        t = x.permute(0, 2, 3, 1)
        if pad_b or pad_r:
            t = F.pad(t, (0, 0, 0, pad_r, 0, pad_b))
        tokens = window_partition(t, ws)
        for blk in self.blocks:
            tokens = blk(tokens)
        t = window_reverse(tokens, ws, H + pad_b, W + pad_r)[:, :H, :W, :]
        return t.permute(0, 3, 1, 2)


class MambaVision(nn.Module):
    """``forward(x)`` takes NCHW images and returns the taps; ``classify(x)``
    the logits (``norm``, the global mean pool, ``head``), where ``head``."""

    def __init__(self, variant: str = "T", num_classes: int = 1000, head: bool = False, device=None, dtype=None):
        super().__init__()
        spec = spec_of(variant)
        f = dict(device=device, dtype=dtype)
        dim = spec["dim"]
        self.variant = variant
        self.patch_embed = PatchEmbed(spec["in_dim"], dim, **f)
        self.levels = nn.ModuleList(
            Level(dim * 2 ** i, spec["depths"][i], spec["heads"][i], spec["window"][i], conv=i < 2,
                  downsample=i < 3, layer_scale=spec["layer_scale"], **f) for i in range(4))
        self.out_channels = dim * 8
        if head:
            self.norm = BatchNorm2d(self.out_channels, eps=1e-5, **f)
            self.head = nn.Linear(self.out_channels, num_classes, **f)

    def forward(self, x: torch.Tensor, perturbations: Optional[dict] = None) -> dict[str, torch.Tensor]:
        """The taps, named as the ResNet's; ``perturbations`` as ``models/resnet.py::perturb``
        (``mdhs_tpu/models/mamba_vision.py:269-308``)."""
        x = perturb(perturbations, "stem", self.patch_embed(x))
        taps = {"stem": x}
        for i, level in enumerate(self.levels):
            x = perturb(perturbations, f"layer{i + 1}", level(x))
            taps[f"layer{i + 1}"] = x
            if level.downsample is not None:
                x = level.downsample(x)
        return taps

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self(x)["layer4"])
        return self.head(x.mean(dim=(2, 3)))
