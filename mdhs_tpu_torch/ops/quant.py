"""Dynamic int8 (a8w8) quantized matmul for the int8 serving preset.

Counterpart of ``mdhs_tpu/ops/quant.py``: per-output-channel weight scales,
per-row activation scales, symmetric absmax / 127, round half to even
(``torch.round``), clip to +-127::

    w_i8[n, k] = round(w[n, k] / sw[n]),   sw[n] = max_k |w[n, k]| / 127
    x_i8[m, k] = round(x[m, k] / sx[m]),   sx[m] = max_k |x[m, k]| / 127
    y[m, n]    = float(x_i8 @ w_i8^T)_int32 * sx[m] * sw[n] + b[n]

Weights are in nn.Linear layout ``(N, K)``, so a channel is a row of the
weight (the JAX ``(K, N)`` kernel reduces over axis 0 instead). The integer
product accumulates in int32 and is converted to float32 once: an int32
matmul on the CPU, ``torch._int_mm`` on CUDA. This is the composite path of
the preset (the JAX package computes it in XLA, outside any Pallas kernel);
the fused sublayer kernels are ``ops/quant_kernel.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize_weight", "quantize_rows", "int8_dense", "int8_linear", "int_matmul"]


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` rounded as one IEEE division, as JAX computes it. (On CUDA,
    PyTorch divides by a Python number as a product with its float32
    reciprocal, which can be one ulp off; a tensor divisor is divided.)"""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of an ``(N, K)`` weight: (int8 (N, K), float32 scale (N,))."""
    wf = w.float()
    scale = _div127(wf.abs().amax(dim=1).clamp_min(1e-8))
    return torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row quantization of ``(..., K)`` activations: (int8, float32 scale (..., 1))."""
    xf = x.float()
    scale = _div127(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``a @ w^T`` of int8 ``a`` (M, K) and int8 ``w`` (N, K)."""
    if a.device.type == "cuda":
        # torch._int_mm takes M > 16 rows, K and N multiples of 8
        M = a.shape[0]
        pad = max(0, 17 - M)
        out = torch._int_mm(F.pad(a, (0, 0, 0, pad)) if pad else a.contiguous(), w.t())
        return out[:M]
    return a.to(torch.int32) @ w.to(torch.int32).t()


def int8_linear(x: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, bias=None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """a8w8 dense with a weight quantized beforehand (``quantize_weight``)."""
    x_i8, sx = quantize_rows(x)
    lead = x_i8.shape[:-1]
    acc = int_matmul(x_i8.reshape(-1, x_i8.shape[-1]), w_i8)
    y = acc.float() * sx.reshape(-1, 1) * sw[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.reshape(*lead, -1).to(out_dtype)


def int8_dense(x: torch.Tensor, w: torch.Tensor, bias=None,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """a8w8 dense as ``mdhs_tpu.ops.quant.int8_dense``: quantize x per row and
    the ``(N, K)`` weight per output channel, int32 product, rescale, + bias."""
    return int8_linear(x, *quantize_weight(w), bias, out_dtype)
