"""BERT attention sublayer: hand-written CUDA kernel and its plain version.

    out = LayerNorm(x + MHA(x @ Wqkv^T + bqkv; bias) @ Wo^T + bo)

Counterpart of ``mdhs_tpu/ops/attention_block.py``; the kernel is
``csrc/attention_block.cu`` (its header comment has the design). Weights are
in nn.Linear layout: ``wqkv`` is ``(3*HD, HD)`` = [Wq; Wk; Wv], ``wo`` is
``(HD, HD)``.

``attention_block`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it returns ``attention_block_reference``. Its
``launches`` attribute counts calls that launched the kernel.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["attention_block", "attention_block_reference", "supports"]

_QT = 64  # query rows per block (csrc/attention_block.cu: at::QT)


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def _smem_bytes(seq_len: int, head_dim: int) -> int:
    """Shared memory of one attention block: csrc/attention_block.cu::attn_plan."""
    Lp = (seq_len + 15) // 16 * 16
    Dp = (head_dim + 15) // 16 * 16
    ldk, lds, ldp = Dp + 8, max(Lp, Dp) + 4, Lp + 8
    off = _align128(_QT * ldk * 2)       # Q
    off = _align128(off + Lp * ldk * 2)  # K
    off = _align128(off + Lp * ldk * 2)  # V
    off = _align128(off + _QT * lds * 4)  # scores, float32
    return _align128(off + _QT * ldp * 2)  # probabilities, bf16


def supports(dtype: torch.dtype, seq_len: int, hidden: int, num_heads: int) -> bool:
    """The kernel's own gate, from the card's limits rather than TPU VMEM.

    bf16 only; ``hidden == num_heads * head_dim`` with ``head_dim % 8 == 0``;
    ``hidden`` a multiple of 128 up to 1024 (the GEMM tiles and the
    row-LayerNorm block); and every L whose attention tile fits the 227 KB of
    shared memory a block may use (L <= 320 at head_dim 64).
    """
    if num_heads <= 0 or hidden % num_heads:
        return False
    head_dim = hidden // num_heads
    return (
        dtype == torch.bfloat16
        and head_dim % 8 == 0
        and hidden % 128 == 0
        and hidden <= 1024
        and seq_len >= 1
        and _smem_bytes(seq_len, head_dim) <= 232448
    )


def _layer_norm_f32(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    mu = y.mean(dim=-1, keepdim=True)
    yc = y - mu
    var = (yc * yc).mean(dim=-1, keepdim=True)
    return yc * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def attention_block_reference(x, wqkv, bqkv, wo, bo, gamma, beta, bias,
                              num_heads: int, sm_scale: float, ln_eps: float) -> torch.Tensor:
    """Plain PyTorch version with the kernel's order of roundings.

    Products of the input dtype accumulate in float32; qkv, the softmax
    probabilities and ctx are rounded to ``x.dtype`` where the kernel rounds
    them; the residual, bias and LayerNorm are float32.
    """
    B, L, HD = x.shape
    D = HD // num_heads
    dt = x.dtype
    xf = x.float()
    qkv = (xf @ wqkv.float().t() + bqkv.float()).to(dt).float()
    q, k, v = (t.reshape(B, L, num_heads, D).transpose(1, 2) for t in qkv.split(HD, dim=-1))
    scores = q @ k.transpose(-1, -2) * sm_scale + bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(dt).float()
    ctx = (probs @ v).transpose(1, 2).reshape(B, L, HD).to(dt).float()
    y = xf + ctx @ wo.float().t() + bo.float()
    return _layer_norm_f32(y, gamma, beta, ln_eps).to(dt)


def attention_block(x, wqkv, bqkv, wo, bo, gamma, beta, bias,
                    num_heads: int, sm_scale: float, ln_eps: float) -> torch.Tensor:
    """Attention sublayer. x: (B, L, HD); bias: (B, L) float32 additive key bias."""
    if x.device.type == "cpu":
        return attention_block_reference(x, wqkv, bqkv, wo, bo, gamma, beta, bias,
                                         num_heads, sm_scale, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"attention_block: unsupported device {x.device}")
    B, L, HD = x.shape
    if not supports(x.dtype, L, HD, num_heads):
        raise ValueError(
            f"attention_block: unsupported dtype={x.dtype}, L={L}, hidden={HD}, heads={num_heads}"
        )
    dev, dt = x.device, x.dtype
    for t, name, shape in ((x, "x", (B, L, HD)), (wqkv, "wqkv", (3 * HD, HD)),
                           (bqkv, "bqkv", (3 * HD,)), (wo, "wo", (HD, HD)), (bo, "bo", (HD,)),
                           (gamma, "gamma", (HD,)), (beta, "beta", (HD,))):
        _build.require(t, name, shape, dt, dev)
    _build.require(bias, "bias", (B, L), torch.float32, dev)
    lib = _build.load_library()
    qkv = torch.empty((B * L, 3 * HD), dtype=dt, device=dev)
    ctx = torch.empty((B * L, HD), dtype=dt, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.attention_block_forward(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), bias.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
            out.data_ptr(), B, L, HD, num_heads, float(sm_scale), float(ln_eps),
            _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "attention_block_forward")
    attention_block.launches += 1
    return out


attention_block.launches = 0
