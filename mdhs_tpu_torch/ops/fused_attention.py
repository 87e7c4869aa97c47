"""Multi-head attention core: hand-written CUDA kernel and its plain version.

    ctx = softmax(q . k * sm_scale + bias) @ v      per head

on q, k, v in the JAX layout ``(B, L, num_heads * head_dim)``. Counterpart of
``mdhs_tpu/ops/fused_attention.py``; the kernel is ``csrc/fused_attention.cu``
(its header comment has the design). BERT uses it for the sequences that
``attention_block``'s shared-memory gate rejects, seq 512 among them.

``fused_attention`` calls the ``mdhs::fused_attention`` custom op
(``ops/_library.py``), so ``torch.export`` keeps it as one node: for a CUDA
tensor the op launches the kernel (``launch_fused_attention``) and raises if
it cannot; for a CPU tensor it returns ``attention_reference``. Its
``launches`` attribute counts calls that launched the kernel.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_attention", "attention_reference", "launch_fused_attention", "supports"]

# the Hopper mainloop's plan (csrc/attention_sm90.cuh: sm90::QT, KT, CHUNK, stages(), plan())
_QT = _KT = 128  # query rows of a block, keys of a streamed tile
_CHUNK = 64      # bf16 columns of one 128-byte swizzled chunk
_MAX_SEQ = 512   # BertConfig.max_position_embeddings


def _chunks(head_dim: int) -> int:
    return (head_dim + _CHUNK - 1) // _CHUNK


def _stages(head_dim: int) -> int:
    """Stages of the K/V ring: 3 at head_dim <= 64, 2 above."""
    return 3 if _chunks(head_dim) == 1 else 2


def _smem_bytes(head_dim: int) -> int:
    """Shared memory of one block: csrc/attention_sm90.cuh::plan. 1024 bytes
    of alignment slack, two Q tiles (the current work item's and the next
    one's), the ring's K and V tiles (128 bytes a row of each 64-column
    chunk), each stage's 128 key words, the mbarriers."""
    nc, st = _chunks(head_dim), _stages(head_dim)
    tiles = 2 * nc * _QT * 128 + st * 2 * nc * _KT * 128
    return 1024 + tiles + st * _KT * 4 + (4 + 2 * st) * 8


def supports(dtype: torch.dtype, seq_len: int, hidden: int, num_heads: int) -> bool:
    """The kernel's own gate, from the card's limits rather than TPU VMEM:
    bf16; ``hidden == num_heads * head_dim`` with ``head_dim % 8 == 0`` and
    ``head_dim <= 128`` (two 64-column chunks of wgmma accumulators); any
    ``1 <= L <= 512`` (K and V stream through shared memory in tiles, the
    last one masked; the TPU's ``L % 128 == 0`` condition goes); the block's
    shared memory within the card's 232,448 bytes."""
    if num_heads <= 0 or hidden % num_heads:
        return False
    head_dim = hidden // num_heads
    return (
        dtype == torch.bfloat16
        and head_dim % 8 == 0
        and 0 < head_dim <= 128
        and 1 <= seq_len <= _MAX_SEQ
        and _smem_bytes(head_dim) <= 232448
    )


def attention_reference(q, k, v, bias, num_heads: int, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version with the kernel's order of roundings: float32
    scores and softmax, probabilities rounded to ``q.dtype``, float32 PV
    accumulation, ctx rounded to ``q.dtype``. (The JAX ``attention_reference``
    rounds the scores to the input dtype too; its kernel does not.)"""
    B, L, HD = q.shape
    D = HD // num_heads
    dt = q.dtype

    def heads(t):
        return t.float().reshape(B, L, num_heads, D).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2) * sm_scale + bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(dt).float()
    return (probs @ heads(v)).transpose(1, 2).reshape(B, L, HD).to(dt)


def fused_attention(q, k, v, bias, num_heads: int, sm_scale: float) -> torch.Tensor:
    """Attention core. q, k, v: (B, L, HD); bias: (B, L) float32 additive key bias."""
    if q.device.type == "cuda":
        B, L, HD = q.shape
        if not supports(q.dtype, L, HD, num_heads):
            raise ValueError(f"fused_attention: unsupported dtype={q.dtype}, L={L}, hidden={HD}, heads={num_heads}")
    elif q.device.type != "cpu":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return torch.ops.mdhs.fused_attention.default(q, k, v, bias, int(num_heads), float(sm_scale))


def launch_fused_attention(q, k, v, bias, num_heads: int, sm_scale: float) -> torch.Tensor:
    """The kernel on CUDA tensors: the op's CUDA implementation."""
    B, L, HD = q.shape
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, (B, L, HD), q.dtype, dev)
    _build.require(bias, "bias", (B, L), torch.float32, dev)
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.fused_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, L, HD, num_heads, float(sm_scale), _build.stream_of(dev),
        )
    _build.check_launch(lib, err, "fused_attention_forward")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
