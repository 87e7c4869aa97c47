"""Grad-CAM over the image tower's taps, functionally (no hooks).

Counterpart of ``mdhs_tpu/analysis/gradcam.py`` (reference
analysis_tools.py:9-140): CAMs over the taps ``stem``, ``layer1`` ..
``layer4`` of the baseline family's ResNet or MambaVision tower. The model
adds a zero tensor at each tap (``models/resnet.py::perturb``, flax's
``perturb``), so the gradient with respect to it is the activation's, and
``torch.autograd.grad`` over those tensors alone gives every layer's in one
backward, as ``jax.grad`` over the perturbations collection does; no
parameter's ``.grad`` is written. Per layer: the weights are the spatial mean
of the gradient in float32, ``cam = relu(einsum("bchw,bc->bhw", a, w))``,
divided by its max where the max is > 0, resized bilinearly to the input size
with ``jax.image.resize``'s weight matrices
(``models/baseline.py::resize_weights``), then averaged over the layers and
the average divided by its max. Taps are NCHW here, NHWC in JAX.

``visualize_cam`` is the JET overlay (analysis_tools.py:122-140) in numpy:
OpenCV's ``COLORMAP_JET`` as a 256 x 3 RGB table (``JET``, equal to
``cv2.applyColorMap`` bit for bit), with the same uint8 arithmetic.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.baseline import resize_weights

DEFAULT_LAYERS = ("stem", "layer1", "layer2", "layer3", "layer4")

# OpenCV's COLORMAP_JET in RGB order, one byte an entry for each channel
JET = np.stack([np.frombuffer(bytes.fromhex("".join(rows)), np.uint8) for rows in (
    ("00" * 96,
     "02060a0e12161a1e22262a2e32363a3e42464a4e52565a5e62666a6e72767a7e82868a8e92969a9ea2a6aaaeb2b6babe",
     "c2c6caced2d6dadee2e6eaeef2f6fafe" + "ff" * 64,
     "fcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0aca8a4a09c9894908c888480"),
    ("00" * 33,
     "04080c1014181c2024282c3034383c4044484c5054585c6064686c7074787c8084888c9094989ca0a4a8acb0b4b8bc",
     "c0c4c8ccd0d4d8dce0e4e8ecf0f4f8fc" + "ff" * 64,
     "fcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0aca8a4a09c9894908c8884807c7874706c6864605c5854504c484440",
     "3c3834302c2824201c1814100c080400" + "00" * 32),
    ("8084888c9094989ca0a4a8acb0b4b8bcc0c4c8ccd0d4d8dce0e4e8ecf0f4f8fc" + "ff" * 64,
     "fefaf6f2eeeae6e2dedad6d2cecac6c2bebab6b2aeaaa6a29e9a96928e8a86827e7a76726e6a66625e5a56524e4a4642",
     "3e3a36322e2a26221e1a16120e0a0601" + "00" * 96),
)], axis=1)


def _by_max(cam: torch.Tensor) -> torch.Tensor:
    """Each (H, W) map divided by its max where that is > 0."""
    mx = cam.amax(dim=(1, 2), keepdim=True)
    return torch.where(mx > 0, cam / torch.where(mx > 0, mx, torch.ones_like(mx)), cam)


def resize_bilinear(cam: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w) -> (B, size, size) as ``jax.image.resize(..., "bilinear")``, in cam's dtype."""
    wh = resize_weights(cam.shape[1], size, cam.device, cam.dtype)
    ww = resize_weights(cam.shape[2], size, cam.device, cam.dtype)
    return torch.matmul(wh.transpose(0, 1), torch.matmul(cam, ww))


def gradcam_device(forward: Callable[[dict], tuple], perturbations: Optional[dict] = None, *, target_class=None,
                   layers: Sequence[str] = DEFAULT_LAYERS, image_size: int = 224, return_layer_cams: bool = False):
    """Grad-CAM on the device. ``forward(perturbations) -> (logits (B, C), taps)``
    adds ``perturbations`` at its taps; an empty dict (or None) lets the model
    make them, zeros of each tap's shape. The score is the float32 sum of each
    row's logit at ``target_class`` (an int, or one a row), or at its argmax.
    Returns (cams (B, S, S) float32 in [0, 1], logits) [, {layer: cam}]; a
    model with no tap among ``layers`` raises."""
    perturbations = {} if perturbations is None else perturbations
    logits, taps = forward(perturbations)
    names = [n for n in layers if n in (taps or {})]
    if not names:
        raise ValueError(f"no CAM layers found among {tuple(layers)}")
    scores = logits.float()
    if target_class is None:
        cls = scores.argmax(dim=-1)
    else:
        cls = torch.as_tensor(target_class, dtype=torch.long, device=scores.device).expand(scores.shape[0])
    score = scores.gather(1, cls[:, None]).sum()
    grads = torch.autograd.grad(score, [perturbations[n] for n in names])
    cams, layer_cams = [], {}
    with torch.no_grad():
        for name, g in zip(names, grads):
            w = g.float().mean(dim=(2, 3))  # (B, C): the spatial mean of the gradient
            cam = torch.relu(torch.einsum("bchw,bc->bhw", taps[name].float(), w))
            cam = resize_bilinear(_by_max(cam), image_size)
            cams.append(cam)
            if return_layer_cams:
                layer_cams[name] = cam
        avg = _by_max(sum(cams) / len(cams))
    if return_layer_cams:
        return avg, logits.detach(), layer_cams
    return avg, logits.detach()


def gradcam(forward, perturbations: Optional[dict] = None, *, return_layer_cams: bool = False, **kw):
    """``gradcam_device`` with numpy outputs."""
    out = gradcam_device(forward, perturbations, return_layer_cams=return_layer_cams, **kw)
    host = lambda t: t.float().cpu().numpy()  # noqa: E731
    if return_layer_cams:
        avg, logits, layer_cams = out
        return host(avg), host(logits), {k: host(v) for k, v in layer_cams.items()}
    return host(out[0]), host(out[1])


def visualize_cam(image_rgb01: np.ndarray, cam: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """JET overlay of an (H, W) CAM in [0, 1] on an (H, W, 3) RGB image in [0, 1],
    uint8. The JAX function resizes a heat map of another size with OpenCV; here
    the CAM must have the image's size (``run_analysis`` gives it that)."""
    heat = JET[(cam * 255).astype(np.uint8)]
    base = (np.clip(image_rgb01, 0, 1) * 255).astype(np.uint8)
    if base.shape[:2] != heat.shape[:2]:
        raise ValueError(f"the CAM is {heat.shape[:2]}, the image {base.shape[:2]}: they must agree")
    return (alpha * heat + (1 - alpha) * base).astype(np.uint8)
