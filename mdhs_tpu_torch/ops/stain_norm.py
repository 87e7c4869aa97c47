"""Stain normalisation on the device: per-image LAB moment matching.

Counterpart of ``mdhs_tpu/ops/stain_norm.py``: each image goes RGB -> XYZ ->
LAB in OpenCV's 8-bit LAB scale (L in [0, 255], a and b offset by 128), its
per-channel mean and standard deviation are moved to a target's, and it goes
back to RGB, clipped to [0, 1]. float32 throughout, the whole batch at once;
elementwise work that XLA fuses in JAX (no Pallas kernel), so plain tensor
ops are its port.

The moments are taken about each image's first pixel, so that a flat
channel's deviations are exactly zero and its standard deviation falls to
the 1e-6 floor: the image comes out at the target. JAX's float32 mean of a
flat image leaves a residue of about one ulp of L (2e-4 to 9e-4, above the
floor), which the division blows up to one target std (20 units of L) either
way; that is where the port departs from it (ROADMAP Queue 3).

The cube root keeps the sign of its argument, as ``jnp.cbrt`` does (its
branch is taken only above (6/29)^3, but both branches are computed). The
RGB -> XYZ matrix, its float32 inverse and the white point are made once per
device, and the targets once per device and value, so a call makes no
host-to-device copy (the ImageNet statistics' rule, ``ops/preprocess.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
_XYZ_REF = np.array([0.950456, 1.0, 1.088754], np.float32)
_D = 6.0 / 29.0

_CONSTANTS: dict = {}


def _constants(device: torch.device, target_mean, target_std) -> tuple[torch.Tensor, ...]:
    """(RGB2XYZ^T, its inverse^T, the white point, target mean, target std), float32 on ``device``."""
    key = (device, tuple(float(v) for v in target_mean), tuple(float(v) for v in target_std))
    consts = _CONSTANTS.get(key)
    if consts is None:
        inv = np.linalg.inv(_RGB2XYZ).astype(np.float32)  # float32 in, float32 out, as jnp.linalg.inv
        with torch.inference_mode(False):
            consts = tuple(torch.tensor(a, dtype=torch.float32, device=device)
                           for a in (_RGB2XYZ.T, inv.T, _XYZ_REF, key[1], key[2]))
        _CONSTANTS[key] = consts
    return consts


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c > 0.0031308, 1.055 * c ** (1 / 2.4) - 0.055, 12.92 * c)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


def _f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _D ** 3, _cbrt(t), t / (3 * _D * _D) + 4.0 / 29.0)


def _f_inv(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _D, t ** 3, 3 * _D * _D * (t - 4.0 / 29.0))


def rgb_to_lab_u8(rgb01: torch.Tensor, rgb2xyz_t: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] -> LAB in OpenCV's 8-bit scale."""
    xyz = _srgb_to_linear(rgb01) @ rgb2xyz_t / white
    fx, fy, fz = _f(xyz[..., 0]), _f(xyz[..., 1]), _f(xyz[..., 2])
    L = 116.0 * fy - 16.0
    return torch.stack([L * 255.0 / 100.0, 500.0 * (fx - fy) + 128.0, 200.0 * (fy - fz) + 128.0], dim=-1)


def lab_u8_to_rgb(lab: torch.Tensor, xyz2rgb_t: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    fy = (lab[..., 0] * 100.0 / 255.0 + 16.0) / 116.0
    fx = fy + (lab[..., 1] - 128.0) / 500.0
    fz = fy - (lab[..., 2] - 128.0) / 200.0
    xyz = torch.stack([_f_inv(fx), _f_inv(fy), _f_inv(fz)], dim=-1) * white
    return _linear_to_srgb(xyz @ xyz2rgb_t)


def stain_normalize(rgb01: torch.Tensor, target_mean=(150.0, 140.0, 140.0),
                    target_std=(20.0, 20.0, 20.0)) -> torch.Tensor:
    """rgb01: (B, H, W, 3) float32 in [0, 1]; the targets in 8-bit LAB units.
    Each image's LAB channels standardised (a std below 1e-6 taken as 1),
    moved to the target moments, clipped to [0, 255], back to RGB in [0, 1]."""
    rgb2xyz_t, xyz2rgb_t, white, tm, ts = _constants(rgb01.device, target_mean, target_std)
    lab = rgb_to_lab_u8(rgb01.float(), rgb2xyz_t, white)
    dev = lab - lab[:, :1, :1]  # about the first pixel: exactly zero on a flat channel
    centred = dev - dev.mean(dim=(1, 2), keepdim=True)
    std = torch.sqrt((centred * centred).mean(dim=(1, 2), keepdim=True))
    std = torch.where(std < 1e-6, 1.0, std)
    lab = torch.clamp(centred / std * ts + tm, 0.0, 255.0)
    return torch.clamp(lab_u8_to_rgb(lab, xyz2rgb_t, white), 0.0, 1.0)
