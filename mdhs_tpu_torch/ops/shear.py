"""Per-row subpixel shear, the core of the 3-shear rotation: hand-written
CUDA kernel and its plain version.

    out[b, c, v, r] = (1 - f) * x[b, c, v + s, r] + f * x[b, c, v + s + 1, r]
    s = clip(pad + floor(d[b, r]), 0, 2*pad - 1),  f = d[b, r] - floor(d[b, r])

Counterpart of ``mdhs_tpu/ops/shear.py``; the kernel is ``csrc/shear.cu``.
``x`` is ``(B, C, S, L)`` float32 with the shear axis ``S`` already
zero-padded by ``pad`` on both sides and ``L`` the row-index axis; ``d`` is
``(B, L)`` float32 shifts in pixels. The result is ``(B, C, S - 2*pad, L)``,
bit-exact against ``mdhs_tpu/ops/augment.py::_shear_w`` (the same lerp, no
FMA).

``shear_sublane`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it returns ``shear_reference``. Its ``launches``
attribute counts calls that launched the kernel.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["shear_sublane", "shear_reference", "supports"]


def supports(x_shape, dtype: torch.dtype, pad: int) -> bool:
    """The kernel's own gate: a float32 (B, C, S, L) input with S > 2*pad,
    and a grid that fits the card's limits (B*C planes at most 65535, and
    ceil(W / 8) at most 65535, which the kernel's 32-row blocks meet with
    room). No shared memory: any L works."""
    if len(x_shape) != 4 or dtype != torch.float32 or pad < 1:
        return False
    B, C, S, L = x_shape
    W = S - 2 * pad
    return B >= 1 and C >= 1 and L >= 1 and W >= 1 and B * C <= 65535 and (W + 7) // 8 <= 65535


def _shift_and_fraction(d: torch.Tensor, pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    d0 = torch.floor(d)
    s = torch.clamp(pad + d0.to(torch.int64), 0, 2 * pad - 1)
    return s, d - d0


def shear_reference(x: torch.Tensor, d: torch.Tensor, pad: int) -> torch.Tensor:
    """Plain PyTorch version: two gathers along S and the lerp, with the
    rounding order of ``_shear_w`` (``(1 - f) * lo + f * hi``)."""
    B, C, S, L = x.shape
    W = S - 2 * pad
    s, f = _shift_and_fraction(d, pad)
    rows = s[:, None, :] + torch.arange(W, device=x.device)[None, :, None]  # (B, W, L)
    rows = rows[:, None].expand(B, C, W, L)
    lo = torch.gather(x, 2, rows)
    hi = torch.gather(x, 2, rows + 1)
    f = f[:, None, None, :]
    return (1.0 - f) * lo + f * hi


def shear_sublane(x: torch.Tensor, d: torch.Tensor, pad: int) -> torch.Tensor:
    """Shear each plane of ``x`` along S by the per-row shifts ``d``."""
    if x.device.type == "cpu":
        return shear_reference(x, d, pad)
    if x.device.type != "cuda":
        raise ValueError(f"shear_sublane: unsupported device {x.device}")
    if not supports(tuple(x.shape), x.dtype, pad):
        raise ValueError(f"shear_sublane: unsupported shape {tuple(x.shape)}, dtype {x.dtype}, pad {pad}")
    B, C, S, L = x.shape
    dev = x.device
    _build.require(x, "x", (B, C, S, L), torch.float32, dev)
    _build.require(d, "d", (B, L), torch.float32, dev)
    lib = _build.load_library()
    out = torch.empty((B, C, S - 2 * pad, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.shear_sublane_forward(x.data_ptr(), d.data_ptr(), out.data_ptr(), B, C, S, L, pad,
                                        _build.stream_of(dev))
    _build.check_launch(lib, err, "shear_sublane_forward")
    shear_sublane.launches += 1
    return out


shear_sublane.launches = 0
