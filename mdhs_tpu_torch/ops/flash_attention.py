"""BERT's flash-attention core: hand-written CUDA kernels and their plain versions.

    o = softmax(q . k * sm_scale + mask) @ v                       per head
    mask[b, i, j] = 0 where seg[b, i] == seg[b, j], else MASK_VALUE

on q, k, v in the JAX layout ``(B, L, num_heads * head_dim)`` with segment
ids ``seg`` (B, L): BERT hands its attention mask (pad 0, real 1), so a
real query sees the real keys and a pad query only the pad keys.
``MASK_VALUE`` is the library's finite ``-0.7 * float32 max``: a row whose
keys in a tile are all masked takes them at probability 1 until a matching
key arrives and its rescale factor wipes them.

Counterpart of the library kernels that ``mdhs_tpu/models/bert.py:196-213``
calls under ``attention_impl="flash"``, in
``jax.experimental.pallas.ops.tpu.flash_attention`` (jax 0.9.0): the forward
``_flash_attention_impl`` (``pl.pallas_call`` at :758, body
``_flash_attention_kernel_single_batch`` :342-482) and the backward
``_flash_attention_bwd_dkv`` (:1121, body :796-940) and
``_flash_attention_bwd_dq`` (:1456, body :1146-1286). The library takes
``di = rowsum(o * do)`` outside its kernels (``_flash_attention_bwd``
:254-305); here the dQ kernel takes it from the O and dO tiles it already
holds and writes it for the dK/dV kernel. The kernels are
``csrc/flash_attention.cu`` and ``csrc/attention_bwd_sm90.cuh`` (their header
comments have the design).

Numerics, fixed by the plain versions and followed by the kernels: float32
scores ``(q . k) * sm_scale``; the row max ``m`` and the row sum ``l`` of
``exp(s - m)`` in float32; the unnormalised probabilities rounded to the input
dtype before the product with ``v``; float32 accumulation, then ``/ l`` and
the rounding to the input dtype. The backward recomputes ``p = exp(s - m) / l``
in float32 and rounds ``p`` (for ``dv = p^T do``) and ``ds = (do v^T - di) *
p * sm_scale`` (for ``dk = ds^T q`` and ``dq = ds k``) to the input dtype
before their products, as the library kernels do.

``flash_attention_forward`` calls the ``mdhs::flash_attention_forward``
custom op (``ops/_library.py``), so ``torch.export`` keeps it as one node:
for a CUDA tensor the op launches the kernel
(``launch_flash_attention_forward``), for a CPU tensor it returns the plain
version. ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq`` (on no
served path) launch their kernel for a CUDA tensor and return their plain
version for a CPU tensor. A CUDA tensor the kernels do not take raises. Each
has its own ``launches`` counter. ``FlashAttention`` is the autograd function over
the three (its backward: dQ, which returns di, then dK/dV); ``flash_attention``
is the op BERT calls.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["FlashAttention", "MASK_VALUE", "attention_di", "flash_attention", "flash_attention_backward_reference",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_reference", "flash_attention_forward", "flash_attention_reference",
           "launch_flash_attention_forward", "supports"]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the library's DEFAULT_MASK_VALUE


def supports(dtype: torch.dtype, seq_len: int, hidden: int, num_heads: int) -> bool:
    """The kernels' own gate, from the card's limits: bf16; ``hidden ==
    num_heads * head_dim`` with ``head_dim % 8 == 0`` and ``head_dim <= 128``
    (the accumulators a thread holds, two 64-column chunks); any ``L >= 1``
    (queries and keys stream in tiles of 128 or 64, the ragged last one
    zero-filled: ``L % 128 == 0`` is BERT's gate, not the kernels'). Each
    kernel's shared-memory plan is the launcher's (``csrc/attention_sm90.cuh::
    plan``, ``csrc/attention_bwd_sm90.cuh::bwd_plan``), which refuses a plan
    past the block's limit; every head_dim admitted here fits."""
    if num_heads <= 0 or hidden % num_heads:
        return False
    head_dim = hidden // num_heads
    return dtype == torch.bfloat16 and head_dim % 8 == 0 and 0 < head_dim <= 128 and seq_len >= 1


# --------------------------------------------------------------------------- plain versions
def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, heads * D) -> (B, heads, L, D) float32."""
    B, L, HD = t.shape
    return t.float().reshape(B, L, num_heads, HD // num_heads).transpose(1, 2)


def _unheads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, heads, L, D) -> (B, L, heads * D) in ``dtype``."""
    B, H, L, D = t.shape
    return t.transpose(1, 2).reshape(B, L, H * D).to(dtype)


def _scores(q, k, seg, num_heads: int, sm_scale: float) -> torch.Tensor:
    """float32 (B, heads, L, L): (q . k) * sm_scale, plus MASK_VALUE across segments."""
    s = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2) * sm_scale
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    return s + torch.where(same, 0.0, MASK_VALUE)


def flash_attention_reference(q, k, v, seg, num_heads: int, sm_scale: float, save_stats: bool = False):
    """Plain forward: o (B, L, HD) in q's dtype, and with ``save_stats`` the
    row max m and row sum l, (B, heads, L) float32. Differentiable."""
    s = _scores(q, k, seg, num_heads, sm_scale)
    m = s.amax(dim=-1).detach()  # any m gives the same o; the library's is the row max
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = _unheads(p.to(q.dtype).float() @ _heads(v, num_heads) / l[..., None], q.dtype)
    return (o, m, l) if save_stats else o


def attention_di(o: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
    """di = rowsum(o * do) per head, (B, heads, L) float32 (library :273-275)."""
    return (o.float() * do.float()).reshape(*o.shape[:2], num_heads, -1).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, seg, m, l, do, di, num_heads: int, sm_scale: float):
    """p = exp(s - m) / l and ds = (do v^T - di) * p * sm_scale, float32."""
    p = torch.exp(_scores(q, k, seg, num_heads, sm_scale) - m[..., None]) / l[..., None]
    dp = _heads(do, num_heads) @ _heads(v, num_heads).transpose(-1, -2)
    return p, (dp - di[..., None]) * p * sm_scale


def flash_attention_bwd_dkv_reference(q, k, v, seg, m, l, do, di, num_heads: int, sm_scale: float):
    """(dk, dv) in q's dtype: dv = bf16(p)^T do, dk = bf16(ds)^T q."""
    dt = q.dtype
    p, ds = _probs_and_ds(q, k, v, seg, m, l, do, di, num_heads, sm_scale)
    dv = p.to(dt).float().transpose(-1, -2) @ _heads(do, num_heads)
    dk = ds.to(dt).float().transpose(-1, -2) @ _heads(q, num_heads)
    return _unheads(dk, dt), _unheads(dv, dt)


def flash_attention_bwd_dq_reference(q, k, v, seg, o, m, l, do, num_heads: int, sm_scale: float):
    """(dq, di): dq = bf16(ds) k in q's dtype, and di = attention_di(o, do)."""
    di = attention_di(o, do, num_heads)
    _, ds = _probs_and_ds(q, k, v, seg, m, l, do, di, num_heads, sm_scale)
    return _unheads(ds.to(q.dtype).float() @ _heads(k, num_heads), q.dtype), di


def flash_attention_backward_reference(q, k, v, seg, o, m, l, do, num_heads: int, sm_scale: float):
    """The plain backward from the forward's residuals o, m, l: (dq, dk, dv)."""
    dq, di = flash_attention_bwd_dq_reference(q, k, v, seg, o, m, l, do, num_heads, sm_scale)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, seg, m, l, do, di, num_heads, sm_scale))


# --------------------------------------------------------------------------- the kernels' wrappers
def _require(what: str, q, k, v, seg, num_heads: int) -> tuple[int, int, int]:
    """Check the operands every kernel takes; return (B, L, HD)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    B, L, HD = q.shape
    if not supports(q.dtype, L, HD, num_heads):
        raise ValueError(f"{what}: unsupported dtype={q.dtype}, L={L}, hidden={HD}, heads={num_heads}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, (B, L, HD), q.dtype, q.device)
    _build.require(seg, "seg", (B, L), torch.int32, q.device)
    return B, L, HD


def _require_stats(q, num_heads: int, **stats) -> None:
    B, L, _ = q.shape
    for name, t in stats.items():
        _build.require(t, name, (B, num_heads, L), torch.float32, q.device)


def flash_attention_forward(q, k, v, seg, num_heads: int, sm_scale: float, save_stats: bool = False):
    """o (B, L, HD), or (o, m, l) with ``save_stats``; seg (B, L) int32."""
    if q.device.type == "cuda":
        B, L, HD = q.shape
        if not supports(q.dtype, L, HD, num_heads):
            raise ValueError(f"flash_attention_forward: unsupported dtype={q.dtype}, L={L}, hidden={HD}, "
                             f"heads={num_heads}")
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention_forward: unsupported device {q.device}")
    o, m, l = torch.ops.mdhs.flash_attention_forward.default(q, k, v, seg, int(num_heads), float(sm_scale),
                                                             bool(save_stats))
    return (o, m, l) if save_stats else o


def launch_flash_attention_forward(q, k, v, seg, num_heads: int, sm_scale: float, save_stats: bool):
    """The kernel on CUDA tensors, the op's CUDA implementation: (o, m, l), m and
    l empty without ``save_stats``."""
    B, L, HD = _require("flash_attention_forward", q, k, v, seg, num_heads)
    dev = q.device
    out = torch.empty_like(q)
    stats = (B, num_heads, L) if save_stats else (0,)
    m = torch.empty(stats, dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
            m.data_ptr() if save_stats else None, l.data_ptr() if save_stats else None,
            B, L, HD, num_heads, float(sm_scale), _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "flash_attention_forward")
    flash_attention_forward.launches += 1
    return out, m, l


def flash_attention_bwd_dkv(q, k, v, seg, m, l, do, di, num_heads: int, sm_scale: float):
    """(dk, dv), each (B, L, HD) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, seg, m, l, do, di, num_heads, sm_scale)
    B, L, HD = _require("flash_attention_bwd_dkv", q, k, v, seg, num_heads)
    _build.require(do, "do", (B, L, HD), q.dtype, q.device)
    _require_stats(q, num_heads, m=m, l=l, di=di)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), m.data_ptr(), l.data_ptr(),
            do.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, L, HD, num_heads, float(sm_scale), _build.stream_of(q.device),
        )
    _build.check_launch(lib, err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, num_heads: int, sm_scale: float):
    """(dq, di): dq (B, L, HD) in q's dtype and di = rowsum(o * do) per head,
    (B, heads, L) float32, which the dK/dV kernel reads."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, seg, o, m, l, do, num_heads, sm_scale)
    B, L, HD = _require("flash_attention_bwd_dq", q, k, v, seg, num_heads)
    _build.require(o, "o", (B, L, HD), q.dtype, q.device)
    _build.require(do, "do", (B, L, HD), q.dtype, q.device)
    _require_stats(q, num_heads, m=m, l=l)
    dq = torch.empty_like(q)
    di = torch.empty((B, num_heads, L), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            do.data_ptr(), dq.data_ptr(), di.data_ptr(),
            B, L, HD, num_heads, float(sm_scale), _build.stream_of(q.device),
        )
    _build.check_launch(lib, err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, di


flash_attention_forward.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """The forward kernel, saving o, m and l; the backward launches the dQ
    kernel, which also returns di, then the dK/dV kernel on that di (no
    atomics: the gradients do not depend on the order the blocks run in)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, num_heads: int, sm_scale: float):
        o, m, l = flash_attention_forward(q, k, v, seg, num_heads, sm_scale, save_stats=True)
        ctx.save_for_backward(q, k, v, seg, o, m, l)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, m, l = ctx.saved_tensors
        h, scale = ctx.num_heads, ctx.sm_scale
        do = do.contiguous()
        dq, di = flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, h, scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, seg, m, l, do, di, h, scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, attention_mask, num_heads: int, sm_scale: float) -> torch.Tensor:
    """The flash core as BERT calls it, (B, L, HD) in q's dtype: the kernels'
    wrappers (``FlashAttention`` where a gradient is wanted, the forward
    alone where not). A CUDA tensor the kernels do not take (float32, say)
    raises; a CPU tensor takes the plain versions."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg = attention_mask.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, seg, num_heads, sm_scale)
    return flash_attention_forward(q, k, v, seg, num_heads, sm_scale)
