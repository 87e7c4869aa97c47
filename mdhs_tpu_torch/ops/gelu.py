"""GELU in the two forms the BERT FFN uses.

Counterpart of ``mdhs_tpu/ops/gelu.py`` (``exact_gelu``) and of the
``fast_math`` activation in ``mdhs_tpu/ops/ffn_block.py::_gelu_tanh_f32``.
Both evaluate in float32 and return the input dtype. The JAX package's
bf16 path evaluates erf through a polynomial-tanh form that is within one
bf16 ulp of erf; here erf itself is used.
"""

from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU: 0.5 * x * (1 + erf(x / sqrt(2))), evaluated in float32."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * (1.0 / math.sqrt(2.0))))).to(x.dtype)


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (the ``fast_math`` preset), evaluated in float32."""
    xf = x.float()
    inner = _SQRT_2_OVER_PI * (xf + 0.044715 * xf * xf * xf)
    return (0.5 * xf * (1.0 + torch.tanh(inner))).to(x.dtype)


def gelu(x: torch.Tensor, act: str = "erf") -> torch.Tensor:
    if act == "erf":
        return exact_gelu(x)
    if act == "tanh":
        return tanh_gelu(x)
    raise ValueError(f"act={act!r}: expected 'erf' or 'tanh'")
