"""Selective scan (the Mamba recurrence): hand-written CUDA kernel and its
plain version.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t        (h in R^N, per (b, d))
    y_t = <C_t, h_t> + D_skip * x_t

Counterpart of ``mdhs_tpu/ops/selective_scan.py``; the kernel is
``csrc/selective_scan.cu`` and replaces the Pallas TPU kernel
``_selective_scan_tpu`` (``pl.pallas_call`` at :112). ``x`` and ``dt`` are
``(batch, L, D)`` float32, ``A`` is ``(D, N)``, ``B`` and ``C`` are
``(batch, L, N)``, ``D_skip`` is ``(D,)``; the result is ``(batch, L, D)``
float32. The kernel is bound by bytes (one read of x and dt, one write of
y); its chains of L sequential steps keep their state in registers, split
over 2 to 8 threads a chain, and read x, dt, B and C from shared memory,
where asynchronous copies bring the next chunk of time steps in under the
current one.

``selective_scan`` calls the ``mdhs::selective_scan`` custom op
(``ops/_library.py``), so ``torch.export`` keeps it as one node: for a CUDA
tensor the op launches the kernel (``launch_selective_scan``) and raises if
it cannot; for a CPU tensor it returns ``selective_scan_reference``, the
sequential loop in the kernel's order (not the JAX package's associative
scan). Its ``launches`` attribute counts calls that launched the kernel.

Its gradient (``ops/_library.py``) is the VJP of
``selective_scan_associative``, the port of ``selective_scan_ref``: the
recurrence as a log-depth associative scan over L with
``jax.lax.associative_scan``'s odd-even recursion, as the JAX custom VJP
(``mdhs_tpu/ops/selective_scan.py:131-148``) differentiates it, not the
sequential loop. The backward recomputes that scan from the forward's
inputs: nothing of it is kept from the forward, whose (B, L, D, N) float32
intermediates are about 103 MB each at (64, 49, 512, 16). It runs as plain
tensor ops on the forward's device, as JAX's backward runs XLA ops.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["launch_selective_scan", "selective_scan", "selective_scan_associative", "selective_scan_reference",
           "supports"]

MAX_STATE = 128  # a group of 8 threads, 16 states each (csrc/selective_scan.cu)


def supports(x_shape, n_state: int, dtype: torch.dtype) -> bool:
    """The kernel's own gate: float32 (batch, L, D) with 1 <= N <= 128 (N 8,
    16 and 128 are the repo's), batch at most 65535 (the grid's y). Any L and D."""
    if len(x_shape) != 3 or dtype != torch.float32:
        return False
    batch, L, D = x_shape
    return 1 <= batch <= 65535 and L >= 1 and D >= 1 and 1 <= n_state <= MAX_STATE


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 where the input is (a gradient check's)."""
    return torch.promote_types(x.dtype, torch.float32)


def selective_scan_reference(x, dt, A, B, C, D_skip) -> torch.Tensor:
    """Plain PyTorch version: the recurrence step by step in float32 (float64
    for float64 inputs)."""
    f = _compute_dtype(x)
    x, dt, A, B, C, D_skip = (t.to(f) for t in (x, dt, A, B, C, D_skip))
    batch, L, D = x.shape
    h = x.new_zeros((batch, D, A.shape[1]))
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t, :, None] * A[None])
        drive = (dt[:, t] * x[:, t])[:, :, None] * B[:, t, None, :]
        h = decay * h + drive
        ys.append((h * C[:, t, None, :]).sum(-1) + D_skip * x[:, t])
    return torch.stack(ys, dim=1)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ...; ``even`` has as many rows as
    ``odd`` or one more."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], dim=1)


def _combine(left, right):
    """(a_l, b_l) then (a_r, b_r): h -> a_r (a_l h + b_l) + b_r."""
    (a_l, b_l), (a_r, b_r) = left, right
    return a_r * a_l, a_r * b_l + b_r


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` over dim 1, ``jax.lax.associative_scan``'s
    recursion: pairs combined, the half scanned, the even rows made from it."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def selective_scan_associative(x, dt, A, B, C, D_skip) -> torch.Tensor:
    """``mdhs_tpu/ops/selective_scan.py::selective_scan_ref`` (:41-68): da =
    exp(dt A), db = dt x B as (batch, L, D, N), their associative scan over L,
    y = <h, C> + D_skip x; float32 (float64 for float64 inputs). The plain
    version the op's backward differentiates."""
    f = _compute_dtype(x)
    x, dt, A, B, C, D_skip = (t.to(f) for t in (x, dt, A, B, C, D_skip))
    da = torch.exp(dt[..., None] * A[None, None])
    db = (dt * x)[..., None] * B[:, :, None, :]
    _, h = _associative_scan(da, db)
    return torch.einsum("bldn,bln->bld", h, C) + x * D_skip[None, None]


def selective_scan(x, dt, A, B, C, D_skip) -> torch.Tensor:
    """y (batch, L, D) of the recurrence; see the module docstring."""
    if x.device.type == "cuda":
        N = A.shape[-1]
        if not supports(tuple(x.shape), N, x.dtype):
            raise ValueError(f"selective_scan: unsupported shape {tuple(x.shape)}, N {N}, dtype {x.dtype}")
    elif x.device.type != "cpu":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    return torch.ops.mdhs.selective_scan.default(x, dt, A, B, C, D_skip)


def launch_selective_scan(x, dt, A, B, C, D_skip) -> torch.Tensor:
    """The kernel on CUDA tensors: the op's CUDA implementation."""
    N = A.shape[-1]
    batch, L, D = x.shape
    dev = x.device
    for t, name, shape in ((x, "x", (batch, L, D)), (dt, "dt", (batch, L, D)), (A, "A", (D, N)),
                           (B, "B", (batch, L, N)), (C, "C", (batch, L, N)), (D_skip, "D_skip", (D,))):
        _build.require(t, name, shape, torch.float32, dev)
    lib = _build.load_library()
    y = torch.empty((batch, L, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.selective_scan_forward(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                         D_skip.data_ptr(), y.data_ptr(), batch, L, D, N, _build.stream_of(dev))
    _build.check_launch(lib, err, "selective_scan_forward")
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
