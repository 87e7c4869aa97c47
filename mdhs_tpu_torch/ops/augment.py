"""Device-side training augmentation: random resized crop, flips, rotation by
three shears, colour jitter and ImageNet normalisation.

Counterpart of ``mdhs_tpu/ops/augment.py``'s fast geometric path
(``_tent_matrix``, ``rotate_3shear``, ``random_crop_flip_rotate``), its
``color_jitter`` with ``_rgb_to_hsv`` / ``_hsv_to_rgb`` (:287-356), and the
JAX Trainer's ``_preprocess_train`` (``mdhs_tpu/train/trainer.py:401-428``).
The images are float32 NHWC ``(B, S, S, C)``, the JAX layout, at every public
function.

JAX's ``random_crop_flip_rotate`` is split in two, so that tests can hand
both packages the same random values:

- ``sample_crop_flip_rotate`` draws, from a ``torch.Generator``, the
  distributions of the JAX ``params`` (``mdhs_tpu/ops/augment.py:178-198``):
  crop area and log aspect ratio, each side clipped to [8, S], offsets, flips,
  angle. ``jax.random`` and ``torch.Generator`` give different numbers from
  one seed; the distributions are the same.
- ``apply_crop_flip_rotate`` is deterministic given those values: the two
  batched tent-matrix products of crop, flip and resize, then the rotation.

``rotate_3shear`` always runs the TPU path's layout
(``mdhs_tpu/ops/augment.py:127-143``): three ``ops/shear.py::shear_sublane``
calls, which launch the CUDA kernel on the card and take the plain version
on the CPU.

Colour jitter is split the same way: ``sample_color_jitter`` draws the
per-image brightness, contrast, saturation and hue factors of
``color_jitter``'s distributions, and ``apply_color_jitter`` is its math on
given factors, in its fixed order (brightness, contrast, saturation, hue).
It is elementwise work (XLA's fusions in JAX, no Pallas kernel), so plain
tensor ops are its port. The MIBF family takes neither jitter nor
normalisation; every other family takes both (the JAX Trainer's defaults,
``trainer.py:174-180``: degrees 45 and vertical flips besides).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .preprocess import normalize_imagenet
from .shear import shear_sublane
from .stain_norm import stain_normalize

SCALE_RANGE = (0.2, 1.0)              # RandomResizedCrop's area fraction
RATIO_RANGE = (3.0 / 4.0, 4.0 / 3.0)  # and aspect ratio (w / h)


def _tent_matrix(pos: torch.Tensor, size: int) -> torch.Tensor:
    """pos: (..., O) float source positions -> (..., O, size) bilinear weights."""
    p0 = torch.floor(pos)
    f = pos - p0
    base = torch.arange(size, dtype=torch.float32, device=pos.device)
    w0 = torch.where(base == torch.clamp(p0, 0, size - 1)[..., None], (1.0 - f)[..., None], 0.0)
    w1 = torch.where(base == torch.clamp(p0 + 1, 0, size - 1)[..., None], f[..., None], 0.0)
    return w0 + w1


def shear_pads(out_size: int, max_degrees: float) -> tuple[int, int]:
    """Static bounds (pad_x, pad_y) on the shifts of the W and H shears."""
    pad_x = int(math.ceil(math.tan(math.radians(max_degrees) / 2.0) * out_size / 2.0)) + 2
    pad_y = int(math.ceil(math.sin(math.radians(max_degrees)) * out_size / 2.0)) + 2
    return pad_x, pad_y


def _pad_shear_axis(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, C, W, L) -> contiguous (B, C, W + 2*pad, L), zero rows on both sides."""
    B, C, W, L = t.shape
    out = t.new_zeros((B, C, W + 2 * pad, L))
    out[:, :, pad:pad + W] = t
    return out


def rotate_3shear(images: torch.Tensor, angles: torch.Tensor, max_degrees: float) -> torch.Tensor:
    """images: (B, H, W, C) float32; angles: (B,) radians. Rotation about the
    image center, bilinear in each shear, zero fill: Shx(a) Shy(b) Shx(a) with
    a = tan(angle/2), b = -sin(angle)."""
    O = images.shape[1]
    pad_x, pad_y = shear_pads(O, max_degrees)
    a = torch.tan(angles / 2.0)[:, None]
    b = -torch.sin(angles)[:, None]
    idx = (torch.arange(O, dtype=torch.float32, device=images.device) - (O - 1) / 2.0)[None, :]
    da, db = a * idx, b * idx
    # (B, H, W, C) -> (B, C, W, H): shear W (the padded axis) indexed by H
    t = shear_sublane(_pad_shear_axis(images.permute(0, 3, 2, 1), pad_x), da, pad_x)
    # -> shear H indexed by W
    t = shear_sublane(_pad_shear_axis(t.transpose(2, 3), pad_y), db, pad_y)
    # -> shear W indexed by H again
    t = shear_sublane(_pad_shear_axis(t.transpose(2, 3), pad_x), da, pad_x)
    return t.permute(0, 3, 2, 1)


class CropFlipRotate(NamedTuple):
    """One batch's sampled augmentation: crop window (y0, x0, h, w) on the
    canvas in pixels, flips, and rotation angle in radians; each (B,), float32
    or bool."""

    y0: torch.Tensor
    x0: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    hflip: torch.Tensor
    vflip: torch.Tensor
    angle: torch.Tensor


def sample_crop_flip_rotate(batch: int, canvas: int, generator: torch.Generator, *, vflip: bool = True,
                            degrees: float = 45.0) -> CropFlipRotate:
    """Draw one batch's values on the generator's device (no host sync):
    horizontal flips always, vertical flips where ``vflip``, angles uniform in
    +-``degrees``."""
    S = float(canvas)
    u = torch.rand((7, batch), generator=generator, device=generator.device)
    area = S * S * (SCALE_RANGE[0] + (SCALE_RANGE[1] - SCALE_RANGE[0]) * u[0])
    lo, hi = math.log(RATIO_RANGE[0]), math.log(RATIO_RANGE[1])
    ratio = torch.exp(lo + (hi - lo) * u[1])
    w = torch.clamp(torch.sqrt(area * ratio), 8.0, S)
    h = torch.clamp(torch.sqrt(area / ratio), 8.0, S)
    y0 = u[2] * (S - h)
    x0 = u[3] * (S - w)
    do_h = u[4] < 0.5
    do_v = (u[5] < 0.5) & vflip
    angle = (-degrees + 2.0 * degrees * u[6]) * math.pi / 180.0
    return CropFlipRotate(y0, x0, h, w, do_h, do_v, angle)


def apply_crop_flip_rotate(images: torch.Tensor, p: CropFlipRotate, out_size: int,
                           degrees: float) -> torch.Tensor:
    """images: (B, S, S, C) float32 -> (B, out, out, C): crop + flips + resize
    as two batched tent-matrix products, then the rotation when degrees > 0."""
    S = images.shape[1]
    idx = torch.arange(out_size, dtype=torch.float32, device=images.device)
    ridx = torch.where(p.vflip[:, None], out_size - 1.0 - idx, idx)
    cidx = torch.where(p.hflip[:, None], out_size - 1.0 - idx, idx)
    rows = p.y0[:, None] + p.h[:, None] / out_size * ridx
    cols = p.x0[:, None] + p.w[:, None] / out_size * cidx
    x = torch.einsum("bos,bshc->bohc", _tent_matrix(rows, S), images)
    x = torch.einsum("bow,bhwc->bhoc", _tent_matrix(cols, S), x)
    if degrees > 0.0:
        x = rotate_3shear(x, p.angle, degrees)
    return x


class ColorJitter(NamedTuple):
    """One batch's colour-jitter factors, each (B,) float32: brightness,
    contrast and saturation multipliers, and the hue shift in turns."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor


def sample_color_jitter(batch: int, generator: torch.Generator, brightness: float = 0.2, contrast: float = 0.2,
                        saturation: float = 0.2, hue: float = 0.1) -> ColorJitter:
    """Uniform factors in 1 +- brightness, 1 +- contrast, 1 +- saturation and a hue
    shift in +- hue, drawn on the generator's device."""
    u = torch.rand((4, batch), generator=generator, device=generator.device)
    return ColorJitter(1.0 - brightness + 2.0 * brightness * u[0], 1.0 - contrast + 2.0 * contrast * u[1],
                       1.0 - saturation + 2.0 * saturation * u[2], -hue + 2.0 * hue * u[3])


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): 0.299 r + 0.587 g + 0.114 b, with no constant tensor made on the device."""
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8), 0.0)
    safe = torch.clamp(delta, min=1e-8)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta < 1e-8, 0.0, h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    # the sector's (r, g, b) of _hsv_to_rgb's jnp.select tables
    table = torch.stack([torch.stack(c, dim=-1) for c in ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                                                          (v, p, q))], dim=-2)  # (..., 6, 3)
    return torch.gather(table, -2, i[..., None, None].expand(*i.shape, 1, 3).long()).squeeze(-2)


def apply_color_jitter(x: torch.Tensor, p: ColorJitter) -> torch.Tensor:
    """x: (B, H, W, 3) float32 in [0, 1]: ``color_jitter``'s math on given factors.
    Brightness scales; contrast blends with the image's mean grayscale; saturation
    with each pixel's grayscale; hue shifts in HSV; each step clipped to [0, 1]."""
    x = torch.clamp(x * p.brightness[:, None, None, None], 0.0, 1.0)
    mean = _gray(x).mean(dim=(1, 2), keepdim=True)[..., None]
    x = torch.clamp((x - mean) * p.contrast[:, None, None, None] + mean, 0.0, 1.0)
    gray = _gray(x)[..., None]
    x = torch.clamp((x - gray) * p.saturation[:, None, None, None] + gray, 0.0, 1.0)
    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + p.hue[:, None, None], 1.0)
    return torch.clamp(_hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1)), 0.0, 1.0)


def train_pipeline(images_uint8: torch.Tensor, generator: torch.Generator, out_size: int = 224, *,
                   degrees: float = 15.0, vflip: bool = False, dtype: torch.dtype = torch.bfloat16,
                   params: CropFlipRotate | None = None, color_jitter: bool = False,
                   jitter: ColorJitter | None = None, normalize: bool = False,
                   stain: tuple | None = None) -> torch.Tensor:
    """uint8 canvases (B, S, S, 3) -> the model's input: NCHW in ``channels_last``
    memory, cast to ``dtype``, as ``ops/preprocess.py::eval_pipeline`` hands it.
    The stain normalisation to ``stain`` = (target mean, target std) where given
    (``ops/stain_norm.py``, on the whole canvas, as ``trainer.py:419-421``), then
    crop, flips and rotation (by default the MIBF mode's degrees 15 and no vflip),
    then the colour jitter where ``color_jitter``, then ImageNet normalisation
    where ``normalize``. ``params`` and ``jitter`` replace the draws from
    ``generator`` with given values. A 5-D stack (B, T, S, S, 3) goes through as
    one batch of B * T images, with one draw over the whole stack, and comes back
    as (B, T, 3, out, out) (``trainer.py:450-455``)."""
    if images_uint8.ndim == 5:
        out = train_pipeline(images_uint8.flatten(0, 1), generator, out_size, degrees=degrees, vflip=vflip,
                             dtype=dtype, params=params, color_jitter=color_jitter, jitter=jitter,
                             normalize=normalize, stain=stain)
        return out.unflatten(0, images_uint8.shape[:2])
    x = images_uint8.to(torch.float32) / 255.0
    if stain is not None:
        x = stain_normalize(x, *stain)
    if params is None:
        params = sample_crop_flip_rotate(x.shape[0], x.shape[1], generator, vflip=vflip, degrees=degrees)
    x = apply_crop_flip_rotate(x, params, out_size, degrees)
    if color_jitter:
        x = apply_color_jitter(x, jitter if jitter is not None else sample_color_jitter(x.shape[0], generator))
    x = normalize_imagenet(x, dtype) if normalize else x.to(dtype)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
