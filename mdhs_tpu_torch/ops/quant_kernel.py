"""int8 (a8w8) BERT sublayers: hand-written CUDA kernels and their plain versions.

    int8_ffn_block:        out = LN(x + deq(rq(gelu(deq(rq(x) @ W1_i8^T) + b1)) @ W2_i8^T) + b2)
    int8_attention_block:  out = LN(x + deq(rq(MHA(deq(rq(x) @ Wqkv_i8^T) + bqkv)) @ Wo_i8^T) + bo)

Counterpart of ``mdhs_tpu/ops/quant_kernel.py``; the kernels are
``csrc/int8_ffn_block.cu`` and ``csrc/int8_attention_block.cu``, whose header
comments have the design: both run their s8 products on the wgmma mainloop
``csrc/gemm_sm90.cuh`` and their last product + residual + LayerNorm on
the cluster epilogue of ``csrc/epi_sm90.cuh``, with the row quantize of
``csrc/int8_gemm.cu``; the attention block's core is ``fused_attention``'s
Hopper mainloop (``csrc/attention_sm90.cuh``) over the packed qkv. ``rq`` is the
kernels' row quantization (absmax times float32(1/127), as the JAX kernels'
``_rowquant_f32``; ``ops/quant.py::quantize_rows`` divides by 127 instead),
``deq`` the float32 rescale ``acc * s_row * s_channel``.

The weights come quantized once, per output channel, by
``ops/quant.py::quantize_weight`` (the JAX wrappers quantize their f32
params on every call): ``w1_i8`` is ``(Di, H)``, ``w2_i8`` ``(H, Di)``,
``wqkv_i8`` ``(3*HD, HD)`` = [Wq; Wk; Wv] and ``wo_i8`` ``(HD, HD)`` int8, with
float32 scales. Biases and LayerNorm parameters are float32 for the kernels.

Each wrapper calls its custom op (``mdhs::int8_ffn_block``,
``mdhs::int8_attention_block``: ``ops/_library.py``), so ``torch.export``
keeps it as one node: for a CUDA tensor the op launches the kernel (the first
output of ``launch_int8_ffn_block`` / ``launch_int8_attention_block``, which
return its scratch too) and raises if it cannot; for a CPU tensor it returns
its ``*_reference``. Its ``launches`` attribute counts calls that launched the
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .bf16_gemm import layer_norm_f32
from .gelu import gelu
from .quant import int_matmul

__all__ = [
    "int8_ffn_block", "int8_ffn_block_reference", "supports", "TILE_COLS", "tile_absmax",
    "scale_from_partials", "ffn_hidden_quant_reference",
    "int8_attention_block", "int8_attention_block_reference", "attn_supports",
    "int8_attention_stages_reference", "launch_int8_attention_block",
]

_ACT_CODES = {"erf": 0, "tanh": 1}
_INV_127 = float(np.float32(1.0 / 127.0))  # jnp.float32(1.0 / 127.0), exactly
# Columns of the FFN kernel's narrowest GEMM1 tile (128 or 256): its pass A
# writes the absmax of h per row and tile, and h's row scale is their maximum
# (csrc/int8_ffn_block.cu).
TILE_COLS = 128


def _rowquant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' row quantization of float32 ``(R, K)``: (int8, scale (R, 1))."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * _INV_127
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def tile_absmax(h: torch.Tensor, cols: int = TILE_COLS) -> torch.Tensor:
    """Pass A's partials: the absmax of each row of float32 ``h`` (R, K) over
    each tile of ``cols`` columns (the last tile ragged), (R, ceil(K / cols))."""
    R, K = h.shape
    tiles = -(-K // cols)
    padded = torch.nn.functional.pad(h.abs(), (0, tiles * cols - K))  # |h| >= 0: zeros change no max
    return padded.reshape(R, tiles, cols).amax(dim=-1)


def scale_from_partials(part: torch.Tensor) -> torch.Tensor:
    """Pass B's row scale from pass A's partials, (R, 1): the largest partial,
    at least 1e-8, times float32(1/127), as ``_rowquant_f32`` scales a row."""
    return part.amax(dim=-1, keepdim=True).clamp_min(1e-8) * _INV_127


def _dequant(x_i8, sx, w_i8, sw) -> torch.Tensor:
    """float32 ``float(x_i8 @ w_i8^T) * sx * sw``, the product exact in int32."""
    return int_matmul(x_i8, w_i8).float() * sx * sw.float()[None, :]


def supports(dtype: torch.dtype, n_rows: int, hidden: int, intermediate: int) -> bool:
    """The int8 FFN kernel's gate, from the card's limits rather than TPU VMEM:
    bf16; any row count (the last tile is masked; the TPU's ``n_rows >= 1024``
    and ``n_rows % 256`` conditions go); ``hidden`` a multiple of 128 up to
    1024 (the row-LayerNorm block) and ``intermediate`` a multiple of 128 (the
    GEMM tiles; both then are multiples of the 64-byte K step)."""
    return (
        dtype == torch.bfloat16
        and n_rows >= 1
        and hidden % 128 == 0
        and 0 < hidden <= 1024
        and intermediate % 128 == 0
        and intermediate > 0
    )


def attn_supports(dtype: torch.dtype, seq_len: int, hidden: int, num_heads: int) -> bool:
    """The int8 attention kernel's gate, from its kernels' limits on the card
    rather than TPU VMEM: bf16; ``hidden`` a multiple of 128 up to 1024 (the
    projections' 128-column tiles and K steps, the LayerNorm cluster of
    hidden / 128 <= 8 blocks); ``head_dim`` a multiple of 8 up to 128 (the
    attention core's tensor maps over the thirds of the packed qkv need
    16-byte rows, and its wgmma accumulators hold two 64-column chunks); and
    ``1 <= L <= 512``, ``fused_attention``'s gate, since the core streams the
    keys through shared memory. The TPU's ``128 <= L <= 256`` condition goes,
    so the preset's seq 256 runs here."""
    if num_heads <= 0 or hidden % num_heads:
        return False
    head_dim = hidden // num_heads
    return (
        dtype == torch.bfloat16
        and hidden % 128 == 0
        and 0 < hidden <= 1024
        and head_dim % 8 == 0
        and head_dim <= 128
        and 1 <= seq_len <= 512
    )


# ---------------------------------------------------------------------------
def ffn_hidden_quant_reference(x2d, w1_i8, s1, b1, act: str = "erf") -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's (h_i8 (N, Di) int8, sh (N,) float32): the kernel's
    two-pass staging, the row scale taken from the tiles' partial maxima."""
    x_i8, sx = _rowquant(x2d.float())
    h = gelu(_dequant(x_i8, sx, w1_i8, s1) + b1.float(), act)
    sh = scale_from_partials(tile_absmax(h))
    return torch.round(h / sh).clamp(-127, 127).to(torch.int8), sh[:, 0]


def int8_ffn_block_reference(x2d, w1_i8, s1, b1, w2_i8, s2, b2, gamma, beta, ln_eps: float,
                             act: str = "erf") -> torch.Tensor:
    """Plain PyTorch version with the kernel's order of roundings: the GELU
    output is re-quantized straight from float32, the residual and LayerNorm
    are float32, the output is rounded once to ``x2d.dtype``."""
    xf = x2d.float()
    h_i8, sh = ffn_hidden_quant_reference(x2d, w1_i8, s1, b1, act)
    y = (xf + _dequant(h_i8, sh[:, None], w2_i8, s2)) + b2.float()
    return layer_norm_f32(y, gamma, beta, ln_eps).to(x2d.dtype)


def int8_ffn_block(x2d, w1_i8, s1, b1, w2_i8, s2, b2, gamma, beta, ln_eps: float,
                   act: str = "erf") -> torch.Tensor:
    """int8 FFN sublayer on (N, H) rows."""
    if act not in _ACT_CODES:
        raise ValueError(f"act={act!r}: expected 'erf' or 'tanh'")
    if x2d.device.type == "cuda":
        N, H = x2d.shape
        Di = w1_i8.shape[0]
        if not supports(x2d.dtype, N, H, Di):
            raise ValueError(f"int8_ffn_block: unsupported dtype={x2d.dtype}, N={N}, H={H}, Di={Di}")
    elif x2d.device.type != "cpu":
        raise ValueError(f"int8_ffn_block: unsupported device {x2d.device}")
    return torch.ops.mdhs.int8_ffn_block.default(x2d, w1_i8, s1, b1, w2_i8, s2, b2, gamma, beta, float(ln_eps), act)


def launch_int8_ffn_block(x2d, w1_i8, s1, b1, w2_i8, s2, b2, gamma, beta, ln_eps: float, act: str):
    """The kernel on CUDA tensors: (out, h_i8, sh), the last two its scratch."""
    if x2d.device.type != "cuda":
        raise ValueError(f"int8_ffn_block: unsupported device {x2d.device}")
    N, H = x2d.shape
    Di = w1_i8.shape[0]
    if not supports(x2d.dtype, N, H, Di):
        raise ValueError(f"int8_ffn_block: unsupported dtype={x2d.dtype}, N={N}, H={H}, Di={Di}")
    dev, f32, i8 = x2d.device, torch.float32, torch.int8
    for t, name, shape, dt in ((x2d, "x2d", (N, H), torch.bfloat16), (w1_i8, "w1_i8", (Di, H), i8),
                               (s1, "s1", (Di,), f32), (b1, "b1", (Di,), f32),
                               (w2_i8, "w2_i8", (H, Di), i8), (s2, "s2", (H,), f32),
                               (b2, "b2", (H,), f32), (gamma, "gamma", (H,), f32),
                               (beta, "beta", (H,), f32)):
        _build.require(t, name, shape, dt, dev)
    lib = _build.load_library()
    x_q = torch.empty((N, H), dtype=i8, device=dev)
    sx = torch.empty((N,), dtype=f32, device=dev)
    part = torch.empty((N, Di // TILE_COLS), dtype=f32, device=dev)  # pass A's row maxima, a tile each at most
    h_q = torch.empty((N, Di), dtype=i8, device=dev)
    sh = torch.empty((N,), dtype=f32, device=dev)
    out = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        err = lib.int8_ffn_block_forward(
            x2d.data_ptr(), w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_i8.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), x_q.data_ptr(),
            sx.data_ptr(), part.data_ptr(), h_q.data_ptr(), sh.data_ptr(), out.data_ptr(),
            N, H, Di, float(ln_eps), _ACT_CODES[act], _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "int8_ffn_block_forward")
    int8_ffn_block.launches += 1
    return out, h_q, sh


int8_ffn_block.launches = 0


# ---------------------------------------------------------------------------
def int8_attention_stages_reference(x, wqkv_i8, sqkv, bqkv, wo_i8, so, bo, gamma, beta, bias,
                                    num_heads: int, sm_scale: float, ln_eps: float):
    """The plain version's stages, as the kernel stages them: (x_i8 (M, HD) int8,
    sx (M,) float32, qkv (M, 3 HD), ctx (M, HD), c_i8 (M, HD) int8, sc (M,)
    float32, out (B, L, HD)), M = B * L, qkv, ctx and out in ``x.dtype``.

    qkv is ``float(x_i8 @ Wqkv_i8^T) * sx * sqkv + bqkv`` in float32, each step
    rounded on its own, then rounded to ``x.dtype``; the core has float32
    scores and softmax (also under fast_math), probabilities and ctx rounded to
    ``x.dtype``: ``fused_attention.attention_reference``'s function on q, k, v,
    the thirds of qkv; the residual and LayerNorm are float32."""
    B, L, HD = x.shape
    D = HD // num_heads
    dt = x.dtype
    xf = x.float().reshape(B * L, HD)
    x_i8, sx = _rowquant(xf)
    qkv = (_dequant(x_i8, sx, wqkv_i8, sqkv) + bqkv.float()).to(dt)
    q, k, v = (t.reshape(B, L, num_heads, D).transpose(1, 2)
               for t in qkv.float().reshape(B, L, 3 * HD).split(HD, dim=-1))
    scores = q @ k.transpose(-1, -2) * sm_scale + bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(dt).float()
    ctx = (probs @ v).transpose(1, 2).reshape(B * L, HD).to(dt)
    c_i8, sc = _rowquant(ctx.float())
    y = (xf + _dequant(c_i8, sc, wo_i8, so)) + bo.float()
    out = layer_norm_f32(y, gamma, beta, ln_eps).to(dt).reshape(B, L, HD)
    return x_i8, sx[:, 0], qkv, ctx, c_i8, sc[:, 0], out


def int8_attention_block_reference(x, wqkv_i8, sqkv, bqkv, wo_i8, so, bo, gamma, beta, bias,
                                   num_heads: int, sm_scale: float, ln_eps: float) -> torch.Tensor:
    """Plain PyTorch version with the kernel's order of roundings
    (``int8_attention_stages_reference``'s last stage)."""
    return int8_attention_stages_reference(x, wqkv_i8, sqkv, bqkv, wo_i8, so, bo, gamma, beta, bias,
                                           num_heads, sm_scale, ln_eps)[-1]


def int8_attention_block(x, wqkv_i8, sqkv, bqkv, wo_i8, so, bo, gamma, beta, bias,
                         num_heads: int, sm_scale: float, ln_eps: float) -> torch.Tensor:
    """int8 attention sublayer. x: (B, L, HD); bias: (B, L) float32 additive key bias."""
    if x.device.type == "cuda":
        B, L, HD = x.shape
        if not attn_supports(x.dtype, L, HD, num_heads):
            raise ValueError(
                f"int8_attention_block: unsupported dtype={x.dtype}, L={L}, hidden={HD}, heads={num_heads}"
            )
    elif x.device.type != "cpu":
        raise ValueError(f"int8_attention_block: unsupported device {x.device}")
    return torch.ops.mdhs.int8_attention_block.default(x, wqkv_i8, sqkv, bqkv, wo_i8, so, bo, gamma, beta, bias,
                                                       int(num_heads), float(sm_scale), float(ln_eps))


def launch_int8_attention_block(x, wqkv_i8, sqkv, bqkv, wo_i8, so, bo, gamma, beta, bias,
                                num_heads: int, sm_scale: float, ln_eps: float):
    """The kernel on CUDA tensors: (out, x_i8, sx, qkv, ctx), the last four its
    scratch in the layout of ``int8_attention_stages_reference``."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_attention_block: unsupported device {x.device}")
    B, L, HD = x.shape
    if not attn_supports(x.dtype, L, HD, num_heads):
        raise ValueError(
            f"int8_attention_block: unsupported dtype={x.dtype}, L={L}, hidden={HD}, heads={num_heads}"
        )
    dev, f32, i8 = x.device, torch.float32, torch.int8
    for t, name, shape, dt in ((x, "x", (B, L, HD), torch.bfloat16), (wqkv_i8, "wqkv_i8", (3 * HD, HD), i8),
                               (sqkv, "sqkv", (3 * HD,), f32), (bqkv, "bqkv", (3 * HD,), f32),
                               (wo_i8, "wo_i8", (HD, HD), i8), (so, "so", (HD,), f32),
                               (bo, "bo", (HD,), f32), (gamma, "gamma", (HD,), f32),
                               (beta, "beta", (HD,), f32), (bias, "bias", (B, L), f32)):
        _build.require(t, name, shape, dt, dev)
    lib = _build.load_library()
    M = B * L
    x_q = torch.empty((M, HD), dtype=i8, device=dev)
    sx = torch.empty((M,), dtype=f32, device=dev)
    qkv = torch.empty((M, 3 * HD), dtype=x.dtype, device=dev)
    ctx = torch.empty((M, HD), dtype=x.dtype, device=dev)
    c_q = torch.empty((M, HD), dtype=i8, device=dev)
    sc = torch.empty((M,), dtype=f32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.int8_attention_block_forward(
            x.data_ptr(), wqkv_i8.data_ptr(), sqkv.data_ptr(), bqkv.data_ptr(), wo_i8.data_ptr(),
            so.data_ptr(), bo.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bias.data_ptr(),
            x_q.data_ptr(), sx.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), c_q.data_ptr(),
            sc.data_ptr(), out.data_ptr(), B, L, HD, num_heads, float(sm_scale), float(ln_eps),
            _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "int8_attention_block_forward")
    int8_attention_block.launches += 1
    return out, x_q, sx, qkv, ctx


int8_attention_block.launches = 0
