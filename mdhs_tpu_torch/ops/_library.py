"""The ``mdhs`` op namespace: the eight kernels on a served path as
``torch.library`` custom ops.

They are defined through ``torch.library.Library`` (``define`` / ``impl``
with ``register_fake``) rather than ``torch.library.custom_op``, whose
Python dispatch added 19-26 us a call on the card's host, 0.54 ms over the
24 calls of an exact MIBF forward, past ``PERF.md``'s 5 % limit on the
batch-1 p50 (``chip_smoke.py``'s ``dispatch_cost_b1``). Each op has three
registrations and no other:

- CPU: the kernel's plain version (``*_reference`` in its module), unchanged;
- CUDA: the kernel's launch (``launch_*`` in its module): it checks its
  operands, allocates its outputs and workspaces, launches, counts the launch
  on the public wrapper's ``launches`` and raises if it cannot;
- fake: the output shapes and dtypes, by the launch's arithmetic, which
  ``torch.export`` traces with.

There is no composite or catch-all kernel, so a CUDA tensor reaches the
launch or raises, and a tensor on any other device finds no kernel. The
kernels are forward only, with no gradient, except ``kan_forward``'s and
``selective_scan``'s, each a plain version's VJP on either device (ConNexT's
and the baseline's training differentiate the MoE bank, and the Mamba
fusion, through the kernels' forwards; JAX's custom VJPs recompute their
plain versions as well). The public
wrappers (``ffn_block(...)``, ``attention_block(...)``, ...) keep their
``supports()`` gates and argument checks in Python and then call
``torch.ops.mdhs.<name>``: the route is decided where the trace runs, as in
JAX, and an exported program holds the op itself. Everything that reads a
data pointer (``_build.require``'s alignment check among it), the launch
plans and the SM count stay in the CUDA implementation, which the trace never
enters.

``mdhs_tpu_torch/ops/__init__.py`` imports this module, so importing any of
the port's ops registers all eight: a process that loads an exported program
(``serving.py::ServingModel.load``) needs that import and no model code.

The kernels on no served path keep their plain wrappers for now:
``shear_sublane``, ``bn_stats`` and ``bn_stats_backward``, the flash
backward pair and ``attention_ablate`` (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from . import attention_block as _ab
from . import ffn_block as _fb
from . import flash_attention as _fl
from . import fused_attention as _fa
from . import kan_spline as _ks
from . import quant_kernel as _qk
from . import selective_scan as _ss

__all__ = ["OPS"]


_LIB = torch.library.Library("mdhs", "DEF")


def _op(name: str, schema: str, plain, launch, fake):
    """Define ``mdhs::name`` with ``plain`` for CPU tensors, ``launch`` for CUDA
    tensors and ``fake`` for tracing."""
    _LIB.define(name + schema)
    _LIB.impl(name, plain, "CPU")
    _LIB.impl(name, launch, "CUDA")
    torch.library.register_fake(f"mdhs::{name}", fake, lib=_LIB)
    return getattr(torch.ops.mdhs, name).default


def _same_shape(x, *rest):
    return x.new_empty(x.shape)


def _flash_forward_plain(q, k, v, seg, num_heads: int, sm_scale: float, save_stats: bool):
    if save_stats:
        return _fl.flash_attention_reference(q, k, v, seg, num_heads, sm_scale, True)
    o = _fl.flash_attention_reference(q, k, v, seg, num_heads, sm_scale)
    return o, q.new_empty((0,), dtype=torch.float32), q.new_empty((0,), dtype=torch.float32)


def _flash_forward_fake(q, k, v, seg, num_heads: int, sm_scale: float, save_stats: bool):
    B, L, _ = q.shape
    stats = (B, num_heads, L) if save_stats else (0,)
    return q.new_empty(q.shape), q.new_empty(stats, dtype=torch.float32), q.new_empty(stats, dtype=torch.float32)


def _int8_ffn_launch(*args):
    return _qk.launch_int8_ffn_block(*args)[0]


def _int8_attention_launch(*args):
    return _qk.launch_int8_attention_block(*args)[0]


def _scan_fake(x, dt, A, B, C, D_skip):
    return x.new_empty(x.shape, dtype=torch.promote_types(x.dtype, torch.float32))


def _kan_fake(x, grid, base_w, spline_w, spline_order: int):
    lead = base_w.shape[:1] if base_w.dim() == 3 else ()
    return x.new_empty((*lead, x.shape[-2], base_w.shape[-2]), dtype=torch.float32)


OPS = {
    "attention_block": _op(
        "attention_block",
        "(Tensor x, Tensor wqkv, Tensor bqkv, Tensor wo, Tensor bo, Tensor gamma, Tensor beta, Tensor bias, "
        "int num_heads, float sm_scale, float ln_eps) -> Tensor",
        _ab.attention_block_reference, _ab.launch_attention_block, _same_shape),
    "ffn_block": _op(
        "ffn_block",
        "(Tensor x2d, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor gamma, Tensor beta, float ln_eps, "
        "str act) -> Tensor",
        _fb.ffn_block_reference, _fb.launch_ffn_block, _same_shape),
    "fused_attention": _op(
        "fused_attention",
        "(Tensor q, Tensor k, Tensor v, Tensor bias, int num_heads, float sm_scale) -> Tensor",
        _fa.attention_reference, _fa.launch_fused_attention, _same_shape),
    "flash_attention_forward": _op(
        "flash_attention_forward",
        "(Tensor q, Tensor k, Tensor v, Tensor seg, int num_heads, float sm_scale, bool save_stats) "
        "-> (Tensor, Tensor, Tensor)",
        _flash_forward_plain, _fl.launch_flash_attention_forward, _flash_forward_fake),
    "int8_ffn_block": _op(
        "int8_ffn_block",
        "(Tensor x2d, Tensor w1_i8, Tensor s1, Tensor b1, Tensor w2_i8, Tensor s2, Tensor b2, Tensor gamma, "
        "Tensor beta, float ln_eps, str act) -> Tensor",
        _qk.int8_ffn_block_reference, _int8_ffn_launch, _same_shape),
    "int8_attention_block": _op(
        "int8_attention_block",
        "(Tensor x, Tensor wqkv_i8, Tensor sqkv, Tensor bqkv, Tensor wo_i8, Tensor so, Tensor bo, Tensor gamma, "
        "Tensor beta, Tensor bias, int num_heads, float sm_scale, float ln_eps) -> Tensor",
        _qk.int8_attention_block_reference, _int8_attention_launch, _same_shape),
    "selective_scan": _op(
        "selective_scan",
        "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor D_skip) -> Tensor",
        _ss.selective_scan_reference, _ss.launch_selective_scan, _scan_fake),
    "kan_forward": _op(
        "kan_forward",
        "(Tensor x, Tensor grid, Tensor base_w, Tensor spline_w, int spline_order) -> Tensor",
        _ks.kan_forward_reference, _ks.launch_kan_forward, _kan_fake),
}


def _kan_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:4])
    ctx.spline_order = inputs[4]


def _kan_backward(ctx, grad):
    """The VJP of ``kan_forward_reference`` for x, base_w and spline_w, and none for
    the grid: ``mdhs_tpu/ops/kan_spline.py::_bwd`` (:150-158), whose backward is XLA
    ops on the TPU too, recomputed here in plain tensor ops on the forward's device."""
    x, grid, base_w, spline_w = ctx.saved_tensors
    _, vjp = torch.func.vjp(lambda a, b, c: _ks.kan_forward_reference(a, grid, b, c, ctx.spline_order),
                            x, base_w, spline_w)
    dx, dbw, dsw = vjp(grad)
    return dx, None, dbw, dsw, None


torch.library.register_autograd("mdhs::kan_forward", _kan_backward, setup_context=_kan_setup_context, lib=_LIB)


def _scan_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _scan_backward(ctx, grad):
    """The VJP of ``selective_scan_associative`` for all six inputs:
    ``mdhs_tpu/ops/selective_scan.py::_bwd`` (:145-147), ``jax.vjp`` of
    ``selective_scan_ref``. The scan is recomputed here from the saved inputs,
    in plain tensor ops on the forward's device; the forward kept none of it."""
    _, vjp = torch.func.vjp(_ss.selective_scan_associative, *ctx.saved_tensors)
    return vjp(grad)


torch.library.register_autograd("mdhs::selective_scan", _scan_backward, setup_context=_scan_setup_context, lib=_LIB)
