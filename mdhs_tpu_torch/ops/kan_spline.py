"""KANLinear forward, ``silu(x) @ Wb^T + Bases(x) @ Ws^T``: hand-written CUDA
kernel and its plain version.

Counterpart of ``mdhs_tpu/ops/kan_spline.py``; the kernel is
``csrc/kan_spline.cu`` and replaces the Pallas TPU kernel
``_kan_forward_pallas`` (``pl.pallas_call`` at :114). Like it, the kernel
makes the B-spline bases of each input on chip and feeds them straight into
the product, so the (B, IN, C) bases tensor is never stored; at layer 0 of the
baseline MoE head it is bound by operations (float32 FMAs). Where the output
tiles are too few to fill the card (the classifier layer's OUT = 7), the
wrapper splits the inputs over more blocks and the kernel adds the partial
sums in a fixed order.

Shapes, float32 throughout: ``x`` (B, IN), ``grid`` (IN, P), ``base_w`` (OUT,
IN), ``spline_w`` (OUT, IN, C) already scaled, giving (B, OUT); or a bank of E
experts with a leading expert axis on ``grid``, ``base_w`` and ``spline_w``,
giving (E, B, OUT), where ``x`` is (E, B, IN) or one (B, IN) that every
expert reads (layer 0 of the MoE bank, ``nn.vmap(in_axes=None)`` in the JAX
package).

``kan_forward`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it returns ``kan_forward_reference``
(``kan_forward_ref``'s math). Its ``launches`` attribute counts calls that
launched the kernel. Eval only: no backward (the training path adds one).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["b_splines", "kan_forward", "kan_forward_reference", "supports"]

N_PTS, ORDER = 12, 3  # the kernel's knots per input and spline order (grid_size 5)
_ROWS, _COLS, _INPUTS = 32, 64, 8  # the kernel's block tile: batch rows, outputs, inputs a K chunk
_BLOCKS_PER_SM = 2


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
    (grid_size 5: every KANLinear of the repo), at most 65535 experts and
    65535 tiles of 32 batch rows. Any B, IN and OUT (ragged tiles are masked)."""
    if dtype != torch.float32 or spline_order != ORDER or grid_shape[-1] != N_PTS:
        return False
    E = base_shape[0] if len(base_shape) == 3 else 1
    B = x_shape[-2]
    return 1 <= E <= 65535 and 1 <= B <= 65535 * 32 and x_shape[-1] >= 1 and base_shape[-2] >= 1


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _split_plan(E: int, B: int, IN: int, OUT: int, n_sm: int) -> tuple[int, int]:
    """(splits, inputs_per_split): split the inputs until the blocks fill about
    two an SM, keeping at least 4 K chunks (32 inputs) a split."""
    row_tiles = -(-B // _ROWS)
    blocks = -(-OUT // _COLS) * row_tiles * E
    chunks = -(-IN // _INPUTS)
    splits = max(1, min(-(-_BLOCKS_PER_SM * n_sm // blocks), chunks // 4, 65535 // row_tiles))
    per = -(-chunks // splits) * _INPUTS
    return -(-IN // per), per


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
    if x.device.type == "cpu":
        return kan_forward_reference(x, grid, base_w, spline_w, spline_order)
    if x.device.type != "cuda":
        raise ValueError(f"kan_forward: unsupported device {x.device}")
    if not supports(tuple(x.shape), tuple(grid.shape), tuple(base_w.shape), spline_order, x.dtype):
        raise ValueError(f"kan_forward: unsupported shapes x {tuple(x.shape)}, grid {tuple(grid.shape)}, "
                         f"base_w {tuple(base_w.shape)}, order {spline_order}, dtype {x.dtype}")
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
    splits, per = _split_plan(E, B, IN, OUT, _sm_count(dev.index))
    y = torch.empty(lead + (B, OUT), dtype=torch.float32, device=dev)
    ws = torch.empty((splits, E, B, OUT) if splits > 1 else (0,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kan_forward(x.data_ptr(), grid.data_ptr(), base_w.data_ptr(), spline_w.data_ptr(), y.data_ptr(),
                              ws.data_ptr() if splits > 1 else None, E, B, IN, OUT, int(shared), splits, per,
                              _build.stream_of(dev))
    _build.check_launch(lib, err, "kan_forward")
    kan_forward.launches += 1
    return y


kan_forward.launches = 0
