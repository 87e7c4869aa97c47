"""Fused test-time augmentation: the variants stacked on the batch axis, one forward.

Counterpart of ``mdhs_tpu/ops/tta.py`` on the port's NCHW crops (``channels_last``
memory, as ``ops/preprocess.py::eval_pipeline`` makes them): the original and
each requested variant (``hflip``, ``vflip``, ``rot90``) go through the model
as one batch of V * B rows, and the V logits of each row are averaged; tensor
arguments (the tokens, a tabular record) are tiled V times, as JAX tiles them.
``rot90`` is ``torch.rot90(k=1, dims=(2, 3))``, which is JAX's NHWC transpose
of H and W followed by a flip of the rows.

A 5-D stack (B, T, C, H, W) takes each variant on every slice's H and W. The
JAX function indexes its axes as those of a 4-D batch, so on a (B, T, H, W, C)
stack its ``hflip`` flips each slice's rows, its ``vflip`` the order of the
slices, and its ``rot90`` raises; the port does not copy that (ROADMAP
Queue 3, documented deviations).
"""

from __future__ import annotations

import torch

TTA_TRANSFORMS = ("hflip", "vflip", "rot90")


def tta_variants(images: torch.Tensor, transforms=TTA_TRANSFORMS) -> torch.Tensor:
    """images (B, [T,] C, H, W) -> (V, B, [T,] C, H, W): the original, then each requested variant."""
    variants = [images]
    for name in transforms:
        if name == "hflip":
            variants.append(images.flip(-1))
        elif name == "vflip":
            variants.append(images.flip(-2))
        elif name == "rot90":
            variants.append(images.transpose(-2, -1).flip(-2))
        else:
            raise ValueError(f"unknown TTA transform {name!r}: expected one of {TTA_TRANSFORMS}")
    return torch.stack(variants, dim=0)


def tta_logits(apply_fn, images: torch.Tensor, *args, transforms=TTA_TRANSFORMS, **kwargs) -> torch.Tensor:
    """``apply_fn(images, *args, **kwargs) -> logits`` over the fused variant batch,
    the logits averaged over the variants. Tensor arguments are tiled on the batch axis."""
    v = tta_variants(images, transforms)
    V, B = v.shape[0], v.shape[1]
    flat = v.reshape(V * B, *v.shape[2:])
    if flat.ndim == 4:
        flat = flat.contiguous(memory_format=torch.channels_last)
    tiled = [torch.cat([a] * V, dim=0) if isinstance(a, torch.Tensor) and a.ndim >= 1 else a for a in args]
    logits = apply_fn(flat, *tiled, **kwargs)
    return logits.reshape(V, B, *logits.shape[1:]).mean(dim=0)
