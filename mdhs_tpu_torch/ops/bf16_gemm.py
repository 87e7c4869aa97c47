"""The bf16 sublayers' products on the wgmma mainloop: their launch plan, and
each product alone.

``csrc/bf16_gemm.cu`` runs each product of ``attention_block`` and
``ffn_block`` on the plan this module makes, and ``plan`` is the one place
that decides it: the tile width, the number of parts K is split into and the
cluster size. The C launchers check the plan and run it as given.
``tile_gemm`` and ``ln_gemm`` run one product alone on its plan, for the
tests that hold each product against a float32 ``torch.matmul``; the
sublayers' wrappers launch their products through their own entry points.

- A tile is 128 rows by ``width`` columns; K streams in steps of 64 bf16.
- The LayerNorm GEMM (``layer_norm``: the output projection and FFN GEMM2)
  runs unsplit as clusters of ``cols / 128`` blocks, one 128-column tile
  each, which merge their rows' statistics through distributed shared memory.
- The tile GEMM (the QKV product, FFN GEMM1) takes 256-column tiles, one block
  an SM, where ``cols`` allows and those tiles fill the card; else 128-column
  tiles, two blocks an SM.
- Where those blocks fill fewer than half the SMs (batch 1: 6 LayerNorm blocks,
  18 QKV tiles and 24 GEMM1 tiles at M = 128 for 132 SMs), K is split into the
  fewest parts that fill half of them, 128-column tiles unclustered. Each part
  writes a float32 partial tile and a row pass sums them and applies the
  epilogue (``csrc/bf16_gemm.cu`` says why a workspace and not a reduction
  within a cluster). Half, because the products at that size are bound by
  reading their weights, which 66 SMs' TMA loads already pull at the memory's
  rate, and each further part adds 4 M N bytes of partials.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build
from .gelu import gelu

__all__ = ["Plan", "plan", "sm_count", "tile_gemm", "tile_gemm_reference", "ln_gemm", "ln_gemm_reference",
           "layer_norm_f32"]

TILE_ROWS = 128   # rows of a tile: two warpgroups of 64
K_STEP = 64       # bf16 values of K a pipeline stage: one 128-byte swizzle row
_NARROW, _WIDE = 128, 256
MAX_CLUSTER = 8   # the portable cluster size: H <= 1024 at 128 columns a block


@dataclasses.dataclass(frozen=True)
class Plan:
    width: int    # tile columns
    splits: int   # parts K is split into (1: unsplit)
    cluster: int  # blocks of a cluster (1: unclustered)
    blocks: int   # blocks with work: tiles x splits

    def args(self) -> tuple[int, int, int]:
        """(width, splits, cluster), as the C launchers take them."""
        return self.width, self.splits, self.cluster

    def workspace(self, rows: int, cols: int) -> int:
        """float32 values of the split-K workspace: a partial tile per split."""
        return self.splits * rows * cols if self.splits > 1 else 0


def plan(rows: int, cols: int, depth: int, layer_norm: bool, sms: int) -> Plan:
    """The plan of C[rows, cols] = A[rows, depth] @ W[cols, depth]^T on a card
    of ``sms`` SMs; ``layer_norm``: the product + residual + LayerNorm, whose
    ``cols`` is the hidden width. ``cols`` is a multiple of 128 and ``depth``
    of 64."""
    if rows < 1 or cols % _NARROW or depth % K_STEP or depth < K_STEP:
        raise ValueError(f"no plan for rows={rows}, cols={cols}, depth={depth}")
    row_tiles = -(-rows // TILE_ROWS)
    narrow_tiles = row_tiles * (cols // _NARROW)
    if layer_norm:
        if cols > MAX_CLUSTER * _NARROW:
            raise ValueError(f"the LayerNorm GEMM takes at most {MAX_CLUSTER * _NARROW} columns, not {cols}")
        unsplit = Plan(_NARROW, 1, cols // _NARROW, narrow_tiles)
    elif cols % _WIDE == 0 and row_tiles * (cols // _WIDE) >= sms:
        unsplit = Plan(_WIDE, 1, 1, row_tiles * (cols // _WIDE))
    else:
        unsplit = Plan(_NARROW, 1, 1, narrow_tiles)
    half = (sms + 1) // 2
    if unsplit.blocks >= half:
        return unsplit
    splits = min(depth // K_STEP, -(-half // narrow_tiles))
    if splits == 1:
        return unsplit
    return Plan(_NARROW, splits, 1, narrow_tiles * splits)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (asked once per device)."""
    return _sms(torch.cuda.current_device() if device.index is None else device.index)


_ACTS = {None: 0, "erf": 1, "tanh": 2}


def tile_gemm_reference(a, w, bias, act=None):
    """bf16(act(a @ w^T + bias)), float32 accumulation and bias, GELU on the
    float32 value, one rounding."""
    y = a.float() @ w.float().t() + bias.float()
    return (y if act is None else gelu(y, act)).to(a.dtype)


def layer_norm_f32(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """The sublayers' LayerNorm in float32: the mean, then the centred sum of squares."""
    mu = y.mean(dim=-1, keepdim=True)
    yc = y - mu
    var = (yc * yc).mean(dim=-1, keepdim=True)
    return yc * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def ln_gemm_reference(a, w, bias, resid, gamma, beta, eps):
    """bf16(LayerNorm((resid + a @ w^T) + bias) * gamma + beta), float32 throughout."""
    y = resid.float() + a.float() @ w.float().t() + bias.float()
    return layer_norm_f32(y, gamma, beta, eps).to(a.dtype)


def _operands(pairs, dev):
    for t, name, shape in pairs:
        _build.require(t, name, shape, torch.bfloat16, dev)


def tile_gemm(a, w, bias, act=None):
    """The tile GEMM alone on a CUDA tensor, on ``plan``'s plan; a CPU tensor
    takes ``tile_gemm_reference``."""
    if act not in _ACTS:
        raise ValueError(f"act={act!r}: expected None, 'erf' or 'tanh'")
    if a.device.type == "cpu":
        return tile_gemm_reference(a, w, bias, act)
    M, K = a.shape
    N, dev = w.shape[0], a.device
    _operands(((a, "a", (M, K)), (w, "w", (N, K)), (bias, "bias", (N,))), dev)
    p = plan(M, N, K, False, sm_count(dev))
    ws = torch.empty((p.workspace(M, N),), dtype=torch.float32, device=dev) if p.splits > 1 else None
    out = torch.empty((M, N), dtype=a.dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.bf16_tile_gemm_forward(a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                         ws.data_ptr() if ws is not None else None, M, N, K, _ACTS[act],
                                         *p.args(), _build.stream_of(dev))
    _build.check_launch(lib, err, "bf16_tile_gemm_forward")
    return out


def ln_gemm(a, w, bias, resid, gamma, beta, eps: float):
    """The LayerNorm GEMM alone on a CUDA tensor, on ``plan``'s plan; a CPU
    tensor takes ``ln_gemm_reference``."""
    if a.device.type == "cpu":
        return ln_gemm_reference(a, w, bias, resid, gamma, beta, eps)
    M, K = a.shape
    H, dev = w.shape[0], a.device
    _operands(((a, "a", (M, K)), (w, "w", (H, K)), (bias, "bias", (H,)), (resid, "resid", (M, H)),
               (gamma, "gamma", (H,)), (beta, "beta", (H,))), dev)
    p = plan(M, H, K, True, sm_count(dev))
    ws = torch.empty((p.workspace(M, H),), dtype=torch.float32, device=dev) if p.splits > 1 else None
    out = torch.empty((M, H), dtype=a.dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.bf16_ln_gemm_forward(a.data_ptr(), w.data_ptr(), bias.data_ptr(), resid.data_ptr(),
                                       gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                                       ws.data_ptr() if ws is not None else None, M, H, K, float(eps),
                                       *p.args(), _build.stream_of(dev))
    _build.check_launch(lib, err, "bf16_ln_gemm_forward")
    return out
