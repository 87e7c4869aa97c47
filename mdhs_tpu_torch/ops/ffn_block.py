"""BERT FFN sublayer: hand-written CUDA kernel and its plain version.

    out = LayerNorm(x + gelu(x @ W1^T + b1) @ W2^T + b2)

Counterpart of ``mdhs_tpu/ops/ffn_block.py``; the kernel is
``csrc/ffn_block.cu`` (its header comment has the design): GEMM1 + bias +
GELU and GEMM2 + residual + LayerNorm on the bf16 wgmma mainloop
(``csrc/bf16_gemm.cu``), each on the plan ``ops/bf16_gemm.py`` makes. Weights are in nn.Linear layout: ``w1`` is
``(Di, H)``, ``w2`` is ``(H, Di)``. ``act`` is "erf" (exact GELU) or "tanh"
(the ``fast_math`` preset).

``ffn_block`` calls the ``mdhs::ffn_block`` custom op (``ops/_library.py``),
so ``torch.export`` keeps it as one node: for a CUDA tensor the op launches
the kernel (``launch_ffn_block``) and raises if it cannot; for a CPU tensor it
returns ``ffn_block_reference``. Its ``launches`` attribute counts calls that
launched the kernel.
"""

from __future__ import annotations

import torch

from . import _build
from . import bf16_gemm
from .bf16_gemm import layer_norm_f32
from .gelu import gelu

__all__ = ["ffn_block", "ffn_block_reference", "launch_ffn_block", "supports", "plans"]

_ACT_CODES = {"erf": 0, "tanh": 1}


def supports(dtype: torch.dtype, n_rows: int, hidden: int, intermediate: int) -> bool:
    """The kernel's own gate: bf16; any row count (the last tile is masked);
    ``hidden`` a multiple of 128 up to 1024 (the row-LayerNorm block) and
    ``intermediate`` a multiple of 128 (the GEMM tiles)."""
    return (
        dtype == torch.bfloat16
        and n_rows >= 1
        and hidden % 128 == 0
        and 0 < hidden <= 1024
        and intermediate % 128 == 0
        and intermediate > 0
    )


def plans(rows: int, hidden: int, intermediate: int, sms: int) -> tuple[bf16_gemm.Plan, bf16_gemm.Plan]:
    """The launch plans of GEMM1 (+ bias + GELU) and of GEMM2 + residual +
    LayerNorm at ``rows`` rows."""
    return (bf16_gemm.plan(rows, intermediate, hidden, False, sms),
            bf16_gemm.plan(rows, hidden, intermediate, True, sms))


def ffn_block_reference(x2d, w1, b1, w2, b2, gamma, beta, ln_eps: float, act: str = "erf") -> torch.Tensor:
    """Plain PyTorch version with the kernel's order of roundings: float32
    accumulation, GELU on the float32 pre-activation, h rounded to
    ``x2d.dtype``, float32 residual and LayerNorm."""
    dt = x2d.dtype
    xf = x2d.float()
    h = gelu(xf @ w1.float().t() + b1.float(), act).to(dt).float()
    y = xf + h @ w2.float().t() + b2.float()
    return layer_norm_f32(y, gamma, beta, ln_eps).to(dt)


def ffn_block(x2d, w1, b1, w2, b2, gamma, beta, ln_eps: float, act: str = "erf") -> torch.Tensor:
    """FFN sublayer on (N, H) rows."""
    if act not in _ACT_CODES:
        raise ValueError(f"act={act!r}: expected 'erf' or 'tanh'")
    if x2d.device.type == "cuda":
        N, H = x2d.shape
        Di = w1.shape[0]
        if not supports(x2d.dtype, N, H, Di):
            raise ValueError(f"ffn_block: unsupported dtype={x2d.dtype}, N={N}, H={H}, Di={Di}")
    elif x2d.device.type != "cpu":
        raise ValueError(f"ffn_block: unsupported device {x2d.device}")
    return torch.ops.mdhs.ffn_block.default(x2d, w1, b1, w2, b2, gamma, beta, float(ln_eps), act)


def launch_ffn_block(x2d, w1, b1, w2, b2, gamma, beta, ln_eps: float, act: str) -> torch.Tensor:
    """The kernel on CUDA tensors: the op's CUDA implementation."""
    N, H = x2d.shape
    Di = w1.shape[0]
    dev, dt = x2d.device, x2d.dtype
    for t, name, shape in ((x2d, "x2d", (N, H)), (w1, "w1", (Di, H)), (b1, "b1", (Di,)),
                           (w2, "w2", (H, Di)), (b2, "b2", (H,)), (gamma, "gamma", (H,)),
                           (beta, "beta", (H,))):
        _build.require(t, name, shape, dt, dev)
    lib = _build.load_library()
    p1, p2 = plans(N, H, Di, bf16_gemm.sm_count(dev))
    h = torch.empty((N, Di), dtype=dt, device=dev)  # intermediate, through device memory
    work = max(p1.workspace(N, Di), p2.workspace(N, H))
    ws = torch.empty((work,), dtype=torch.float32, device=dev) if work else None
    out = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        err = lib.ffn_block_forward(
            x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), h.data_ptr(), ws.data_ptr() if ws is not None else None,
            out.data_ptr(), N, H, Di, float(ln_eps), _ACT_CODES[act], *p1.args(), *p2.args(),
            _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "ffn_block_forward")
    ffn_block.launches += 1
    return out


ffn_block.launches = 0
