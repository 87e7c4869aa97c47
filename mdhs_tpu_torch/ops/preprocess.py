"""Device-side eval preprocessing: uint8 canvas -> float image for the model.

Counterpart of ``mdhs_tpu/ops/preprocess.py``. The public functions take the
JAX layout, uint8 NHWC ``(B, 256, 256, 3)``; ``eval_pipeline`` hands the
model NCHW in ``channels_last`` memory, which is a ``permute`` of the
contiguous NHWC result (no copy).
"""

from __future__ import annotations

import torch

from ..device import device_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


_STATS: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) float32 on ``device``, made once (``device_constant``)."""
    return device_constant(_STATS, device, lambda: (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
                                                    torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)))


def normalize_imagenet(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (..., 3) float32 in [0, 1] -> ImageNet-normalized, cast to dtype."""
    mean, std = imagenet_stats(x.device)
    return ((x - mean) / std).to(dtype)


def to_float(x_uint8: torch.Tensor) -> torch.Tensor:
    return x_uint8.to(torch.float32) / 255.0


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Static center crop of an NHWC (or NTHWC) tensor; returns a view."""
    H, W = x.shape[-3], x.shape[-2]
    y0 = (H - size) // 2
    x0 = (W - size) // 2
    return x[..., y0 : y0 + size, x0 : x0 + size, :]


def eval_pipeline(images_uint8: torch.Tensor, image_size: int = 224,
                  normalize: bool = True, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 NHWC canvas batch -> center-cropped float NCHW (channels_last).

    ``normalize=False`` is the MIBF pipeline, which has no Normalize. A 5-D
    stack (B, T, S, S, 3) comes back as (B, T, 3, size, size).
    """
    if images_uint8.ndim == 5:
        return eval_pipeline(images_uint8.flatten(0, 1), image_size, normalize, dtype).unflatten(
            0, images_uint8.shape[:2])
    x = to_float(center_crop(images_uint8, image_size)).contiguous()
    x = normalize_imagenet(x, dtype) if normalize else x.to(dtype)
    return x.permute(0, 3, 1, 2)
