"""BERT attention sublayer: hand-written CUDA kernel and its plain version.

    out = LayerNorm(x + MHA(x @ Wqkv^T + bqkv; bias) @ Wo^T + bo)

Counterpart of ``mdhs_tpu/ops/attention_block.py``; the kernel is
``csrc/attention_block.cu`` (its header comment has the design): the QKV
product and the output projection + LayerNorm on the bf16 wgmma mainloop
(``csrc/bf16_gemm.cu``), each on the plan ``ops/bf16_gemm.py`` makes, and the
core on ``fused_attention``'s Hopper mainloop over the packed qkv. Weights are
in nn.Linear layout: ``wqkv`` is ``(3*HD, HD)`` = [Wq; Wk; Wv], ``wo`` is
``(HD, HD)``.

``attention_block`` calls the ``mdhs::attention_block`` custom op
(``ops/_library.py``), so ``torch.export`` keeps it as one node: for a CUDA
tensor the op launches the kernel (``launch_attention_block``) and raises if
it cannot; for a CPU tensor it returns ``attention_block_reference``. Its
``launches`` attribute counts calls that launched the kernel.
"""

from __future__ import annotations

import torch

from . import _build
from . import bf16_gemm
from .bf16_gemm import layer_norm_f32

__all__ = ["attention_block", "attention_block_reference", "launch_attention_block", "supports", "plans"]

# The longest L the block takes at each head_dim, by ceil(head_dim / 16): the
# lengths whose score tile fit the 227 KB of shared memory of the block's first
# design (a whole head's K and V and a 64 x L float32 score tile). The core is
# now fused_attention's, which takes any L up to 512, but the limit stays: it
# is the route BERT takes (models/bert.py::_kernel_plan), so seq 512, and
# every L past these, stays on fused_attention as JAX routes it. Widening it
# is a decision of its own (ROADMAP.md).
_MAX_SEQ = {1: 464, 2: 400, 3: 352, 4: 320, 5: 288, 6: 256, 7: 240, 8: 224}


def supports(dtype: torch.dtype, seq_len: int, hidden: int, num_heads: int) -> bool:
    """The kernel's own gate, from the card's limits rather than TPU VMEM.

    bf16 only; ``hidden == num_heads * head_dim`` with ``head_dim % 8 == 0``
    and ``head_dim <= 128`` (the core's two 64-column chunks); ``hidden`` a
    multiple of 128 up to 1024 (the GEMM tiles and the LayerNorm GEMM's
    cluster of hidden / 128 blocks); and ``1 <= L <= _MAX_SEQ`` (L <= 320 at
    head_dim 64).
    """
    if num_heads <= 0 or hidden % num_heads:
        return False
    head_dim = hidden // num_heads
    return (
        dtype == torch.bfloat16
        and head_dim % 8 == 0
        and head_dim <= 128
        and hidden % 128 == 0
        and hidden <= 1024
        and 1 <= seq_len <= _MAX_SEQ.get(-(-head_dim // 16), 0)
    )


def plans(rows: int, hidden: int, sms: int) -> tuple[bf16_gemm.Plan, bf16_gemm.Plan]:
    """The launch plans of the QKV product and of the output projection +
    LayerNorm, at ``rows`` = B * L."""
    return (bf16_gemm.plan(rows, 3 * hidden, hidden, False, sms),
            bf16_gemm.plan(rows, hidden, hidden, True, sms))


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
    return layer_norm_f32(y, gamma, beta, ln_eps).to(dt)


def attention_block(x, wqkv, bqkv, wo, bo, gamma, beta, bias,
                    num_heads: int, sm_scale: float, ln_eps: float) -> torch.Tensor:
    """Attention sublayer. x: (B, L, HD); bias: (B, L) float32 additive key bias."""
    if x.device.type == "cuda":
        B, L, HD = x.shape
        if not supports(x.dtype, L, HD, num_heads):
            raise ValueError(
                f"attention_block: unsupported dtype={x.dtype}, L={L}, hidden={HD}, heads={num_heads}"
            )
    elif x.device.type != "cpu":
        raise ValueError(f"attention_block: unsupported device {x.device}")
    return torch.ops.mdhs.attention_block.default(x, wqkv, bqkv, wo, bo, gamma, beta, bias, int(num_heads),
                                                  float(sm_scale), float(ln_eps))


def launch_attention_block(x, wqkv, bqkv, wo, bo, gamma, beta, bias,
                           num_heads: int, sm_scale: float, ln_eps: float) -> torch.Tensor:
    """The kernel on CUDA tensors: the op's CUDA implementation."""
    B, L, HD = x.shape
    dev, dt = x.device, x.dtype
    for t, name, shape in ((x, "x", (B, L, HD)), (wqkv, "wqkv", (3 * HD, HD)),
                           (bqkv, "bqkv", (3 * HD,)), (wo, "wo", (HD, HD)), (bo, "bo", (HD,)),
                           (gamma, "gamma", (HD,)), (beta, "beta", (HD,))):
        _build.require(t, name, shape, dt, dev)
    _build.require(bias, "bias", (B, L), torch.float32, dev)
    lib = _build.load_library()
    M = B * L
    p_qkv, p_out = plans(M, HD, bf16_gemm.sm_count(dev))
    qkv = torch.empty((M, 3 * HD), dtype=dt, device=dev)
    ctx = torch.empty((M, HD), dtype=dt, device=dev)
    work = max(p_qkv.workspace(M, 3 * HD), p_out.workspace(M, HD))
    ws = torch.empty((work,), dtype=torch.float32, device=dev) if work else None
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.attention_block_forward(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), bias.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
            ws.data_ptr() if ws is not None else None, out.data_ptr(), B, L, HD, num_heads,
            float(sm_scale), float(ln_eps), *p_qkv.args(), *p_out.args(), _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "attention_block_forward")
    attention_block.launches += 1
    return out


attention_block.launches = 0
