"""KANLinear forward, ``silu(x) @ Wb^T + Bases(x) @ Ws^T``: hand-written CUDA
kernel and its plain version.

Counterpart of ``mdhs_tpu/ops/kan_spline.py``; the kernel is
``csrc/kan_spline.cu`` and replaces the Pallas TPU kernel
``_kan_forward_pallas`` (``pl.pallas_call`` at :114). Like it, the kernel
makes the B-spline bases of each input on chip and feeds them straight into
the product, so the (B, IN, C) bases tensor is never stored. The products run
on the tensor cores at float32 accuracy (3xTF32: each operand split into a
TF32 high and low part, three products); at layer 0 of the baseline MoE head
the kernel is bound by the bytes of the weights. ``plan`` picks its tile
orientation and how far the inputs are split over blocks, so that the tiles
fill the card; the splits are added in a fixed order inside the same launch.

Shapes, float32 throughout: ``x`` (B, IN), ``grid`` (IN, P), ``base_w`` (OUT,
IN), ``spline_w`` (OUT, IN, C) already scaled, giving (B, OUT); or a bank of E
experts with a leading expert axis on ``grid``, ``base_w`` and ``spline_w``,
giving (E, B, OUT), where ``x`` is (E, B, IN) or one (B, IN) that every
expert reads (layer 0 of the MoE bank, ``nn.vmap(in_axes=None)`` in the JAX
package).

``kan_forward`` calls the ``mdhs::kan_forward`` custom op
(``ops/_library.py``), so ``torch.export`` keeps it as one node: for a CUDA
tensor the op launches the kernel (``launch_kan_forward``) and raises if it
cannot; for a CPU tensor it returns ``kan_forward_reference``
(``kan_forward_ref``'s math). Its ``launches`` attribute counts calls that
launched the kernel, and ``launches_by_layer`` the same calls by the layer's
(IN, OUT). Eval only: no backward (the training path adds one).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["Plan", "b_splines", "kan_forward", "kan_forward_reference", "launch_kan_forward", "plan", "supports"]

N_PTS, ORDER = 12, 3  # the kernel's knots per input and spline order (grid_size 5)
STAGE_INPUTS = 32  # inputs of one silu stage of K (32 floats of Wb): splits hold whole ones
ROWS_M = 128  # a wide tile's weight rows (two warpgroups' wgmma M)
BATCH_ROWS = 64  # a tile's batch rows: the wide tile's wgmma N, the narrow one's M
NARROW_OUT = 16  # at most this many outputs: the narrow orientation


def b_splines(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> torch.Tensor:
    """Cox-de Boor recursion, ``mdhs_tpu/modules/kan.py::b_splines``' order of
    operations: x (..., IN), grid (IN, P) -> bases (..., IN, P - 1 - order)."""
    x = x[..., None].float()
    g = grid.float()
    bases = ((x >= g[..., :-1]) & (x < g[..., 1:])).float()
    for k in range(1, spline_order + 1):
        left = (x - g[..., : -(k + 1)]) / (g[..., k:-1] - g[..., : -(k + 1)])
        right = (g[..., k + 1:] - x) / (g[..., k + 1:] - g[..., 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


def supports(x_shape, grid_shape, base_shape, spline_order: int, dtype: torch.dtype) -> bool:
    """The kernel's own gate: float32, 12 knots an input with spline order 3
    (grid_size 5: every KANLinear of the repo). Any E, B, IN and OUT (ragged
    tiles are masked) whose stacked weight rows E * OUT fit an int32."""
    if dtype != torch.float32 or spline_order != ORDER or grid_shape[-1] != N_PTS:
        return False
    E = base_shape[0] if len(base_shape) == 3 else 1
    return E >= 1 and x_shape[-2] >= 1 and x_shape[-1] >= 1 and 1 <= base_shape[-2] and E * base_shape[-2] < 2 ** 31


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel. ``bn`` 64: wide tiles of 128 weight rows (one
    expert's) by 64 batch rows; 8 or 16: narrow tiles of 64 batch rows by
    ``bn`` outputs. The inputs go in ``splits`` ranges of ``per`` (whole
    stages of 32), the last one ragged, none empty."""

    bn: int
    row_tiles: int
    col_tiles: int
    tiles: int
    splits: int
    per: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


def plan(E: int, B: int, IN: int, OUT: int, n_sm: int) -> Plan:
    """The narrow orientation at OUT <= 16 (the classifier layer: OUT = 7 on 8
    columns), else the wide one; then the inputs split until the tiles fill
    about one block an SM (a block takes most of an SM's shared memory)."""
    if OUT <= NARROW_OUT:
        bn = 8 if OUT <= 8 else NARROW_OUT
        row_tiles, col_tiles = -(-B // BATCH_ROWS), -(-OUT // bn)
    else:
        bn = BATCH_ROWS
        row_tiles, col_tiles = -(-OUT // ROWS_M), -(-B // BATCH_ROWS)
    tiles = E * row_tiles * col_tiles
    stages = -(-IN // STAGE_INPUTS)
    splits = max(1, min(-(-n_sm // tiles), stages))
    per = -(-stages // splits) * STAGE_INPUTS
    return Plan(bn, row_tiles, col_tiles, tiles, -(-IN // per), per)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_counters: dict[tuple[int, int], torch.Tensor] = {}


def _tile_counters(dev: torch.device, tiles: int) -> torch.Tensor:
    """The split-K counters of one device and stream, one int a tile: zero
    between launches (the last block of a tile resets its own), so they are
    made once and kept."""
    key = (dev.index, _build.stream_of(dev))
    c = _counters.get(key)
    if c is None or c.numel() < tiles:
        c = _counters[key] = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
    return c


def kan_forward_reference(x, grid, base_w, spline_w, spline_order: int = ORDER) -> torch.Tensor:
    """Plain PyTorch version: ``kan_forward_ref``'s two products, per expert."""
    if base_w.dim() == 3:
        xs = x if x.dim() == 3 else x.expand(base_w.shape[0], *x.shape)
        return torch.stack([kan_forward_reference(*a, spline_order) for a in zip(xs, grid, base_w, spline_w)])
    x = x.float()
    base = F.silu(x) @ base_w.float().T
    bases = b_splines(x, grid, spline_order)
    spline = bases.reshape(x.shape[0], -1) @ spline_w.float().reshape(spline_w.shape[0], -1).T
    return base + spline


def kan_forward(x, grid, base_w, spline_w, spline_order: int = ORDER) -> torch.Tensor:
    """y (B, OUT), or (E, B, OUT) for a bank; see the module docstring."""
    if x.device.type == "cuda":
        if not supports(tuple(x.shape), tuple(grid.shape), tuple(base_w.shape), spline_order, x.dtype):
            raise ValueError(f"kan_forward: unsupported shapes x {tuple(x.shape)}, grid {tuple(grid.shape)}, "
                             f"base_w {tuple(base_w.shape)}, order {spline_order}, dtype {x.dtype}")
    elif x.device.type != "cpu":
        raise ValueError(f"kan_forward: unsupported device {x.device}")
    return torch.ops.mdhs.kan_forward.default(x, grid, base_w, spline_w, int(spline_order))


def launch_kan_forward(x, grid, base_w, spline_w, spline_order: int) -> torch.Tensor:
    """The kernel on CUDA tensors: the op's CUDA implementation."""
    bank = base_w.dim() == 3
    E = base_w.shape[0] if bank else 1
    OUT, IN = base_w.shape[-2:]
    B = x.shape[-2]
    shared = bank and x.dim() == 2
    lead = (E,) if bank else ()
    dev = x.device
    _build.require(x, "x", (B, IN) if x.dim() == 2 else (E, B, IN), torch.float32, dev)
    _build.require(grid, "grid", lead + (IN, N_PTS), torch.float32, dev)
    _build.require(base_w, "base_w", lead + (OUT, IN), torch.float32, dev)
    _build.require(spline_w, "spline_w", lead + (OUT, IN, N_PTS - 1 - ORDER), torch.float32, dev)
    lib = _build.load_library()
    p = plan(E, B, IN, OUT, _sm_count(dev.index))
    # TMA reads rows whose pitch is a multiple of 16 bytes: Wb's is IN floats, padded
    # with zero columns where IN is not a multiple of 4 (no layer of the repo's models)
    ldb = -(-IN // 4) * 4
    bw = base_w if ldb == IN else F.pad(base_w, (0, ldb - IN))
    y = torch.empty(lead + (B, OUT), dtype=torch.float32, device=dev)
    split = p.splits > 1
    ws = torch.empty((p.splits, E, B, OUT) if split else (0,), dtype=torch.float32, device=dev)
    counters = _tile_counters(dev, p.tiles) if split else None
    with torch.cuda.device(dev):
        err = lib.kan_forward(x.data_ptr(), grid.data_ptr(), bw.data_ptr(), spline_w.data_ptr(), y.data_ptr(),
                              ws.data_ptr() if split else None, counters.data_ptr() if split else None,
                              E, B, IN, OUT, ldb, int(shared), p.bn, p.row_tiles, p.col_tiles, p.splits, p.per,
                              _build.stream_of(dev))
    _build.check_launch(lib, err, "kan_forward")
    kan_forward.launches += 1
    kan_forward.launches_by_layer[IN, OUT] = kan_forward.launches_by_layer.get((IN, OUT), 0) + 1
    return y


kan_forward.launches = 0
kan_forward.launches_by_layer = {}
