"""BatchNorm batch statistics in one read: hand-written CUDA kernel and its
plain version.

``bn_stats(x)`` returns the float32 per-channel mean and biased variance of a
channels-last activation ``x`` (..., C) over all its leading axes. Counterpart
of ``mdhs_tpu/ops/bn_stats.py``; the kernel is ``csrc/bn_stats.cu``
(block-local two-pass statistics merged with Chan's combine, never the
cancellation-prone E[x^2] - mu^2).

The gradient is a ``torch.autograd.Function`` whose backward is the JAX
package's analytic VJP (``mdhs_tpu/ops/bn_stats.py:190-203``) in plain
PyTorch: the TPU kernel has no backward kernel either.

``bn_stats`` launches the kernel for a CUDA tensor and raises if it cannot;
for a CPU tensor its forward is ``bn_stats_reference``. Its ``launches``
attribute counts calls that launched the kernel. The TPU gate's
``_row_block`` divisor rule and its multi-device guard are facts of the TPU
and its sharded jit, and are not carried over.
"""

from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["bn_stats", "bn_stats_reference", "supports"]

_TILE = 128                     # rows a block stages in shared memory at a time (csrc/bn_stats.cu)
_COLS = 32                      # channels a block owns
_BLOCKS_PER_SM = 8              # 256-thread blocks with 17 KB of shared memory: 8 fit an SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports(shape, dtype: torch.dtype) -> bool:
    """The kernel's own gate: bf16 or float32, at least one row and one
    channel, and fewer than 2^24 rows, so that the row counts of Chan's
    combine are exact in float32."""
    if len(shape) < 2 or dtype not in _DTYPES:
        return False
    C = shape[-1]
    R = 1
    for s in shape[:-1]:
        R *= s
    return 1 <= R < (1 << 24) and C >= 1


def bn_stats_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass float32 statistics, as ``mdhs_tpu.ops.bn_stats.bn_stats_reference``."""
    x32 = x.float()
    axes = tuple(range(x.ndim - 1))
    mean = x32.mean(dim=axes)
    var = torch.square(x32 - mean).mean(dim=axes)
    return mean, var


def _plan(R: int, C: int, n_sm: int) -> tuple[int, int]:
    """(groups, rows_per_group): row groups of whole 128-row tiles, as many as
    fill about eight blocks an SM across the column tiles."""
    tiles = -(-R // _TILE)
    col_tiles = -(-C // _COLS)
    want = max(1, min(tiles, -(-_BLOCKS_PER_SM * n_sm // col_tiles)))
    rows_per_group = -(-tiles // want) * _TILE
    return -(-R // rows_per_group), rows_per_group


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    R, C = x2d.shape
    dev = x2d.device
    groups, rows_per_group = _plan(R, C, _sm_count(dev.index))
    lib = _build.load_library()
    partial = torch.empty((2, groups, C), dtype=torch.float32, device=dev)  # (mean, M2) per group
    out = torch.empty((2, C), dtype=torch.float32, device=dev)  # (mean, var)
    p, o = partial.data_ptr(), out.data_ptr()
    with torch.cuda.device(dev):
        err = lib.bn_stats_forward(x2d.data_ptr(), _DTYPES[x2d.dtype], p, p + 4 * groups * C, o, o + 4 * C,
                                   R, C, rows_per_group, groups, _build.stream_of(dev))
    _build.check_launch(lib, err, "bn_stats_forward")
    bn_stats.launches += 1
    return out[0], out[1]


class _BnStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x2d = x.reshape(-1, x.shape[-1])
        mean, var = _launch(x2d.contiguous()) if x.is_cuda else bn_stats_reference(x2d)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        # d mean / dx = 1/n, d var / dx = 2 (x - mu) / n, in the JAX VJP's order
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        dx = dmean / n + dvar * 2.0 * (x.float() - mean) / n
        return dx.to(x.dtype)


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) over all leading axes of ``x`` (..., C),
    float32 (C,) each; differentiable."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_stats: unsupported device {x.device}")
    if x.is_cuda and not supports(tuple(x.shape), x.dtype):
        raise ValueError(f"bn_stats: unsupported shape {tuple(x.shape)} or dtype {x.dtype}")
    return _BnStats.apply(x)


bn_stats.launches = 0
