"""The fused attention core with one stage removed: hand-written CUDA kernel
and its plain version, for timing the core stage by stage.

    full     ctx = softmax(q . k * sm_scale + bias) @ v      per head (fused_attention)
    nomax    the softmax without the max subtraction
    nosmax   no softmax: the probabilities are the scores, cast
    nopv     no P V product: a head's D columns are the first D keys' probabilities
    aligned  every head reads head 0's columns; only columns 0 .. D-1 are written

on q, k, v in the JAX layout ``(B, L, num_heads * head_dim)``. Counterpart of
``benchmarks/attention_ablate.py::make_kernel``; the numerics of every mode but
``full`` are wrong on purpose. The kernel is ``csrc/attention_ablate.cu``: each
mode a compile-time variant of ``fused_attention``'s Hopper mainloop, so
``full`` gives ``fused_attention``'s bits.

``attention_ablate`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it returns ``attention_ablate_reference``. Its
``launches`` attribute counts calls that launched the kernel.
"""

from __future__ import annotations

import torch

from . import _build
from . import fused_attention as fa

__all__ = ["MODES", "attention_ablate", "attention_ablate_reference", "supports"]

MODES = ("full", "nomax", "nosmax", "nopv", "aligned")  # csrc/attention_sm90.cuh::Ablate, in order


def _mode_index(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"attention_ablate: unknown mode {mode!r}, expected one of {MODES}")
    return MODES.index(mode)


def supports(mode: str, dtype: torch.dtype, seq_len: int, hidden: int, num_heads: int) -> bool:
    """``fused_attention``'s gate, the kernel being its mainloop; ``nopv``
    also needs ``seq_len >= head_dim``, as the TPU kernel slices D keys of
    the probabilities. Raises for an unknown mode."""
    _mode_index(mode)
    if not fa.supports(dtype, seq_len, hidden, num_heads):
        return False
    return mode != "nopv" or seq_len >= hidden // num_heads


def attention_ablate_reference(q, k, v, bias, num_heads: int, sm_scale: float, mode: str) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's order of roundings:
    float32 scores, probabilities (p = e * (1 / sum e), or the scores for
    ``nosmax``) rounded to ``q.dtype``, float32 P V, ctx rounded. ``full`` is
    ``fused_attention.attention_reference``. ``aligned`` fills the columns it
    does not write with NaN, as the TPU kernel run in interpret mode leaves them."""
    _mode_index(mode)
    B, L, HD = q.shape
    D = HD // num_heads
    if mode == "nopv" and L < D:
        raise ValueError(f"attention_ablate: nopv needs L >= head_dim, got L={L}, head_dim={D}")
    dt = q.dtype
    n = 1 if mode == "aligned" else num_heads  # aligned: every head is head 0

    def heads(t):
        return t[..., : n * D].float().reshape(B, L, n, D).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2) * sm_scale + bias.float()[:, None, None, :]
    if mode == "nosmax":
        probs = scores.to(dt)
    elif mode == "nomax":
        e = torch.exp(scores)
        probs = (e * (1.0 / e.sum(dim=-1, keepdim=True))).to(dt)
    else:
        probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = probs[..., :D].float() if mode == "nopv" else probs.float() @ heads(v)
    ctx = ctx.transpose(1, 2).reshape(B, L, n * D).to(dt)
    if mode != "aligned":
        return ctx
    out = torch.full_like(q, float("nan"))
    out[..., :D] = ctx
    return out


def attention_ablate(q, k, v, bias, num_heads: int, sm_scale: float, mode: str) -> torch.Tensor:
    """One mode of the attention core. q, k, v: (B, L, HD); bias: (B, L)
    float32 additive key bias. On the card, ``aligned`` leaves ctx's columns
    past head_dim unwritten (``torch.empty``)."""
    index = _mode_index(mode)
    if q.device.type == "cpu":
        return attention_ablate_reference(q, k, v, bias, num_heads, sm_scale, mode)
    if q.device.type != "cuda":
        raise ValueError(f"attention_ablate: unsupported device {q.device}")
    B, L, HD = q.shape
    if not supports(mode, q.dtype, L, HD, num_heads):
        raise ValueError(f"attention_ablate: unsupported mode={mode}, dtype={q.dtype}, L={L}, hidden={HD}, "
                         f"heads={num_heads}")
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, (B, L, HD), q.dtype, dev)
    _build.require(bias, "bias", (B, L), torch.float32, dev)
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.attention_ablate_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, L, HD, num_heads, float(sm_scale), index, _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "attention_ablate_forward")
    attention_ablate.launches += 1
    return out


attention_ablate.launches = 0
