"""BatchNorm batch statistics in one read, and their gradient in one pass:
hand-written CUDA kernels and their plain versions.

``bn_stats(x)`` returns the float32 per-channel mean and biased variance of a
channels-last activation ``x`` (..., C) over all its leading axes. Counterpart
of ``mdhs_tpu/ops/bn_stats.py``; the kernel is ``csrc/bn_stats.cu``
(``bn_stats_kernel``: block-local two-pass statistics merged with Chan's
combine, never the cancellation-prone E[x^2] - mu^2, and the blocks' partials
combined in a fixed order inside the same launch), on the launch plan of
``plan``.

The gradient is a ``torch.autograd.Function`` whose backward is
``bn_stats_backward``: the JAX package's analytic VJP
(``mdhs_tpu/ops/bn_stats.py:190-203``), dx = dmean / n + dvar * 2 (x - mean) / n,
as one hand-written pass (``bn_stats_backward_kernel``) for a CUDA tensor.

Each wrapper launches its kernel for a CUDA tensor and raises if it cannot;
for a CPU tensor it takes its plain version (``bn_stats_reference``,
``bn_stats_backward_reference``). Their ``launches`` attributes count calls
that launched a kernel. The TPU gate's ``_row_block`` divisor rule and its
multi-device guard are facts of the TPU and its sharded jit, and are not
carried over.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build

__all__ = ["Plan", "bn_stats", "bn_stats_backward", "bn_stats_backward_reference", "bn_stats_reference", "plan",
           "supports"]

THREADS = 256              # a block (csrc/bn_stats.cu kThreads)
CHUNK = 4                  # rows a thread holds at once (kChunk)
BLOCKS_PER_SM = 2          # resident blocks an SM (the kernel's launch bounds)
MAX_PER_LANE = 8           # partials a lane of a group's last block combines at most
MIN_SEGMENT = 128          # bytes of a row a channel group reads at least
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports(shape, dtype: torch.dtype) -> bool:
    """The kernels' own gate: bf16 or float32, at least one row and one
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


def bn_stats_backward_reference(x: torch.Tensor, mean: torch.Tensor, dmean: torch.Tensor,
                                dvar: torch.Tensor) -> torch.Tensor:
    """dx of ``bn_stats``: d mean / dx = 1/n, d var / dx = 2 (x - mu) / n, in
    the JAX VJP's order, float32, rounded once to x's dtype. n is a tensor on
    x's device: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, where the VJP (and the kernel) divide."""
    n = torch.tensor(x.numel() // x.shape[-1], dtype=torch.float32, device=x.device)
    dx = dmean / n + dvar * 2.0 * (x.float() - mean) / n
    return dx.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of ``bn_stats_kernel``: ``col_groups`` channel groups of
    ``cols`` channels by ``row_groups`` row groups of ``rows`` rows (the last
    of each ragged, none empty), ``vec`` channels a thread (16 bytes, or 1
    where a row is not a multiple of 16 bytes or x is not aligned)."""

    vec: int
    col_groups: int
    cols: int
    row_groups: int
    rows: int

    @property
    def blocks(self) -> int:
        return self.col_groups * self.row_groups

    @property
    def lanes(self) -> int:
        """Row lanes of a full-width channel group's block: threads that share a vector."""
        return THREADS // (self.cols // self.vec)


def plan(R: int, C: int, itemsize: int, sms: int, aligned: bool = True) -> Plan:
    """The fewest channel groups whose vectors fit a block; then more, by
    halves, while the grid holds fewer blocks than the card has SMs and a
    group still reads at least 128 bytes of a row. Rows go in groups of at
    least a step (a chunk for each row lane), up to two blocks an SM, and at
    most as many as leave each lane of a group's last block 8 partials to
    combine."""
    vector = aligned and (C * itemsize) % 16 == 0
    vec = 16 // itemsize if vector else 1
    vecs = C // vec
    cg = -(-vecs // THREADS)
    while True:
        vg = -(-vecs // cg)
        cg = -(-vecs // vg)
        lanes = THREADS // vg
        groups = max(1, min(-(-R // (CHUNK * lanes)), -(-BLOCKS_PER_SM * sms // cg), MAX_PER_LANE * lanes))
        half = -(-vg // 2)
        if cg * groups >= sms or half == vg or half * vec * itemsize < MIN_SEGMENT:
            break
        cg = -(-vecs // half)
    rows = -(-R // groups)
    return Plan(vec, cg, vg * vec, -(-R // rows), rows)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, partials: int, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The partials and the channel groups' counters of one device and stream,
    kept from call to call: the counters are zero between launches (the last
    block of a group resets its own), so they are made once."""
    key = (dev.index, _build.stream_of(dev))
    ws, counters = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < partials:
        ws = torch.empty(max(partials, 1 << 16), dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < groups:
        counters = torch.zeros(max(groups, 256), dtype=torch.int32, device=dev)
    _workspaces[key] = ws, counters
    return ws, counters


def _launch(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    R, C = x2d.shape
    dev = x2d.device
    p = plan(R, C, x2d.element_size(), _sm_count(dev.index), aligned=x2d.data_ptr() % 16 == 0)
    lib = _build.load_library()
    ws, counters = _workspace(dev, 2 * p.row_groups * C, p.col_groups)
    out = torch.empty((2, C), dtype=torch.float32, device=dev)  # (mean, var)
    with torch.cuda.device(dev):
        err = lib.bn_stats_forward(x2d.data_ptr(), _DTYPES[x2d.dtype], ws.data_ptr(), counters.data_ptr(),
                                   out.data_ptr(), R, C, p.vec, p.col_groups, p.cols, p.row_groups, p.rows,
                                   _build.stream_of(dev))
    _build.check_launch(lib, err, "bn_stats_forward")
    bn_stats.launches += 1
    return out[0], out[1]


def bn_stats_backward(x: torch.Tensor, mean: torch.Tensor, dmean: torch.Tensor, dvar: torch.Tensor) -> torch.Tensor:
    """dx of ``bn_stats(x)`` for upstream gradients (dmean, dvar), x's shape
    and dtype: the hand-written pass for a CUDA tensor, the plain version for
    a CPU one."""
    if not x.is_cuda:
        return bn_stats_backward_reference(x, mean, dmean, dvar)
    C = x.shape[-1]
    if not supports(tuple(x.shape), x.dtype):
        raise ValueError(f"bn_stats_backward: unsupported shape {tuple(x.shape)} or dtype {x.dtype}")
    for name, t in (("mean", mean), ("dmean", dmean), ("dvar", dvar)):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (C,):
            raise ValueError(f"bn_stats_backward: {name} must be float32 ({C},) on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    x2d = x.reshape(-1, C).contiguous()
    mean, dmean, dvar = mean.contiguous(), dmean.contiguous(), dvar.contiguous()  # autograd may expand a scalar
    dx = torch.empty_like(x2d)
    dev = x.device
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.bn_stats_backward(x2d.data_ptr(), _DTYPES[x.dtype], mean.data_ptr(), dmean.data_ptr(),
                                    dvar.data_ptr(), dx.data_ptr(), x2d.shape[0], C, _sm_count(dev.index),
                                    _build.stream_of(dev))
    _build.check_launch(lib, err, "bn_stats_backward")
    bn_stats_backward.launches += 1
    return dx.view(x.shape)


class _BnStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x2d = x.reshape(-1, x.shape[-1])
        mean, var = _launch(x2d.contiguous()) if x.is_cuda else bn_stats_reference(x2d)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        return bn_stats_backward(x, mean, dmean, dvar)


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) over all leading axes of ``x`` (..., C),
    float32 (C,) each; differentiable."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_stats: unsupported device {x.device}")
    if x.is_cuda and not supports(tuple(x.shape), x.dtype):
        raise ValueError(f"bn_stats: unsupported shape {tuple(x.shape)} or dtype {x.dtype}")
    return _BnStats.apply(x)


bn_stats.launches = 0
bn_stats_backward.launches = 0
