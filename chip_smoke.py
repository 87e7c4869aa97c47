#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:
  1. device   require CUDA; the card's name and power limit (nvidia-smi)
  2. build    compile mdhs_tpu_torch/csrc/*.cu with nvcc for sm_90a, one
              process per source, all at once
  3. kernels  each CUDA kernel against its plain PyTorch version on the same
              inputs, at the main paths' shapes: the bf16 kernels within
              max |d| <= 6e-2 and mean |d| < 5e-3 (tests/test_fused_attention.py:
              126-127), the int8 kernels within max |d| <= 0.01 * max |plain|
              (tests/test_quant.py:160) and mean |d| < 5e-3; median CUDA-event
              times of kernel and plain version (around one call: the
              wrapper's host launch included), the kernel's device time
              (torch.profiler), the bound (the larger of
              bytes / 3.35 TB/s and operations / peak rate, from this run's
              shapes, each product counted once), and as the library call
              (timing only, CUDA events and the profiler's device time like
              the kernel's) on the same inputs scaled_dot_product_attention
              for fused_attention, grid_sample for shear_sublane and var_mean
              for bn_stats (none for selective_scan and kan_forward: no one
              PyTorch call computes either); shear_sublane bit-exact;
              bn_stats within rtol 1e-5 and
              atol 1e-6 * E|x| (mean) or * E[x^2] (variance), and its backward
              within 1e-5 of the largest gradient; selective_scan (N 16, and
              N 8 and 128) and kan_forward (both layers of the MoE bank)
              within max |d| <= 1e-4 * max |plain| (float32); BERT's flash
              kernels (the forward at batch 32, seq 512, at seq 256 with the
              statistics m, l the backward reads, and seq 200, against SDPA's
              forward with the boolean segment mask; dK/dV and dQ at batch
              32, seq 256 and 512, against SDPA's backward alone, which makes
              dQ, dK and dV together, so one more line at each shape times the
              port's whole backward, dQ (which takes di) + dK/dV, against it)
              on segment ids with masked tiles, the forward within the bf16
              bound (m, l within atol 1e-3, rtol 1e-4), dQ, dK, dV within
              max |d| <= 0.02 * max |plain| and mean |d| <= 2e-3 * max
              |plain|, the dQ kernel's di within 2 D 2^-24 * sum |o * do| of
              its row; the attention kernels' ptxas registers and spills
              (the flash kernels, fused_attention's and the five
              ablations') print on a build line
  4. ablate   the attention ablation (ops/attention_ablate.py: the fused
              core with one stage removed, five compile-time variants of
              its mainloop) at the TPU script's shape, B 256, L 128, 12
              heads of 64: each mode against its plain version with zero
              bias and with a bias padding the even rows' keys and N(0, 1)
              in the odd rows, within the bf16 bound over each row's
              max(1, max |plain|) (nosmax reaches 1e10 in a padded row),
              nopv's probabilities within one bf16 ulp each (aligned on
              its head_dim columns); full bit-identical to
              fused_attention and aligned's columns to full's; each mode's
              ms, device ms, plain ms and its own bound (the bytes and
              products that mode does), SDPA with the key mask as full's
              library call; then the diagnostic's own chain
              (diagnostics/attention_ablate.py: 20 calls in a CUDA graph):
              ms per call, the chain's device time split into the kernel
              and the elementwise passes, the kernel's share
  5. slice    full-width MIBF-Net (ResNet50 + BERT-base, 7 labels), bf16,
              exact-parity, seeded random weights, through ServingModel(batch
              32): 3 requests (32, 32, 5 rows, seq 128) via predict_stream with
              attention_block and ffn_block launched 12 times a forward; the
              plain path (attention_impl="xla") on the same weights within
              atol 0.15 and mean |d| < 0.01 (tests/test_fused_attention.py:
              97-105); one request at seq 256; images/s at batch 32, p50
              latency at batch 1, tower times and the device breakdown
  6. preset   the int8 serving preset (configs/serving/mibf_ham_serving.yml:
              fast_math, quantize int8, batch 512) at full width, through
              ServingModel(batch 512): 3 requests (512, 512, 77 rows, seq 128)
              via predict_stream with int8_attention_block and int8_ffn_block
              launched 12 times a forward and no bf16 sublayer kernel; one
              request of 512 rows at seq 256 (the preset's tokenizer length),
              12 launches of each; the same model on the int8 composite
              (models/bert.py::int8_composite()) within 0.25 / 0.03 on logits
              and BERT output (INT8_ATOL says why), and the exact bf16 path
              with CLS drift mean |d| < 0.062 *
              max |CLS| (twice docs/PARITY.md:21's TPU drift); images/s at batch
              512 of the preset and of the exact bf16 model in turns, p50
              latency at batch 1, tower times and the device breakdown
  7. seq512   the exact bf16 MIBF-Net, one request of 32 rows at seq 512:
              fused_attention and ffn_block launched 12 times, attention_block
              none; BERT output and logits within 0.15 / 0.01 of the plain path
  8. baseline the baseline family's two served configurations at full width
              (configs/ham/ham_fusion_ssm_v1.yml: ResNet18 layer4 tokens, BERT-
              base, the Mamba fusion, an MLP head; ham_head_moe_v1.yml: layer2/3/4
              tokens, the multiscale fusion, the KAN-expert MoE head), bf16,
              seeded random weights (w_gate drawn, then made orthogonal to the
              mean fused feature so that rows route apart), through ServingModel(batch
              64): 3 requests (64, 64, 9 rows, seq 128) via predict_stream and
              one of 1 row, with attention_block and ffn_block launched 12
              times a forward and selective_scan once or kan_forward twice;
              the same weights with that op routed to its plain version within
              max |d| <= 2^-6 * max |logit| (two bf16 steps: BF16_STEPS says
              why) and mean |d| <= 2^-10 * max |logit|; images/s at batch 64,
              the share of rows routed to each pair of experts; p50 latency
              at batch 1, forward time and the device breakdown
  9. train    MIBF-Net training at full width (MIBF_HAM_TRAIN: batch 32, seq
              256, canvas 256 -> 224, Adam, cosine, MP-Loss), a bf16 module
              with float32 masters, seeded random weights with each
              bottleneck's last BatchNorm scale at 0.1: Trainer.fit over 2
              epochs x 3 steps (the last batch short, n_valid 21) with
              validation on 2 batches an epoch; shear_sublane launched 3 times
              a step and no serving kernel in a step, attention_block and
              ffn_block 12 times a validation forward; finite losses, masters
              and float32 BatchNorm running statistics updated; one batch's
              augmentation through the kernel and the plain shear bit-exact;
              images/s at batch 32 (host clock, 8 steps), step ms split into
              augmentation, forward + backward and optimizer (CUDA events),
              the device breakdown and the step's share of 989 TFLOP/s; the
              bn_stats A/B on the same weights and batch (one launch per
              BatchNorm input the gate takes, none in eval, loss within 1e-2
              relative of cuDNN BatchNorm, step ms of both in turns), the
              kernel's side a trainer of MIBFNet(bn_stats_kernel=True); one step
              of the bf16 module against a float32 twin on the same weights
              and batch with dropout 0 (loss within 2e-2 relative, per-tower
              gradient cosine >= 0.99; reported, not checked, for the seeded
              weights undamped)
 10. flash    the exact model's weights under attention_impl="flash" at seq
              512, through ServingModel(batch 32): 3 requests (32, 32, 5 rows)
              via predict_stream with flash_attention launched 12 times a
              forward and no other kernel; the same weights on the plain flash
              op within SLICE_ATOL / SLICE_MEAN (BERT output, pad rows
              included, and logits), the logits against the exact model; a
              request at seq 128 (12 launches) and one at seq 200 (none: not a
              multiple of 128); images/s, p50 at batch 1, tower times and the
              device breakdown
 11. train_flash  MIBF_HAM_TRAIN with BERT under "flash" and attention dropout
              0: Trainer.fit over 2 steps and a validation batch; a step
              launches shear_sublane 3 times and each flash kernel 12 times,
              a validation forward the forward 12 times; one step against the
              plain flash op (loss within 1e-2 relative, BERT gradient cosine
              >= 0.99); step ms in turns against the same preset under "auto",
              and both steps' device breakdowns
Every served phase (slice, preset, seq512, flash, baseline) runs one warm
forward from device-resident inputs under torch.cuda.set_sync_debug_mode(
"error") ("sync_free"): a call that makes the host wait on the device fails
the script.
Then a JSON line of the kernels, the nvidia-smi line, and the result line.
Each path sets every launch count to 0 just before it runs and reads them
just after. Any failure raises: the exit code is not 0 and no result line is
printed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mdhs_tpu_torch import resolve_device
from mdhs_tpu_torch.diagnostics import attention_ablate as diag
from mdhs_tpu_torch.models.baseline import MultimodalBaselineModel
from mdhs_tpu_torch.models.bert import BertConfig, int8_composite
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet
from mdhs_tpu_torch.models.norm import BatchNorm2d
from mdhs_tpu_torch.modules.kan import make_grid
from mdhs_tpu_torch.modules.moe import noisy_top_k_gating
from mdhs_tpu_torch.ops import _build
from mdhs_tpu_torch.ops import attention_ablate as aa
from mdhs_tpu_torch.ops import attention_block as ab
from mdhs_tpu_torch.ops import augment as aug
from mdhs_tpu_torch.ops import bn_stats as bns
from mdhs_tpu_torch.ops import ffn_block as fb
from mdhs_tpu_torch.ops import flash_attention as fl
from mdhs_tpu_torch.ops import fused_attention as fa
from mdhs_tpu_torch.ops import kan_spline as ks
from mdhs_tpu_torch.ops import quant_kernel as qk
from mdhs_tpu_torch.ops import selective_scan as ss
from mdhs_tpu_torch.ops import shear as sh
from mdhs_tpu_torch.ops.preprocess import eval_pipeline
from mdhs_tpu_torch.ops.quant import quantize_weight
from mdhs_tpu_torch.serving import (BASELINE_BATCH, BASELINE_SEQ, HAM_FUSION_SSM, HAM_HEAD_MOE, MIBF_HAM_SERVING,
                                    ServingModel)
from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer

MAX_ABS, MEAN_ABS = 6e-2, 5e-3           # bf16 kernel vs plain version
INT8_FRAC = 0.01                         # int8 kernel vs plain: max |d| <= 0.01 * max |plain|
SLICE_ATOL, SLICE_MEAN = 0.15, 0.01      # kernel vs plain model path, bf16
# int8 kernels vs the int8 composite. The composite rounds the dequantized
# products to bf16 before the GELU, the residual and each re-quantization
# (the kernels do not: quant_kernel.py:127-129 names the GELU one as the
# intended difference); a bf16 rounding moves x / scale by up to a quarter
# int8 step, so the two paths differ by flipped int8 values, at the size of
# the int8 drift itself. Measured on the card at batch 512: BERT output max
# 0.156, mean 0.020; logits max 0.061, mean 0.014. The bound keeps 1.5x.
INT8_ATOL, INT8_MEAN = 0.25, 0.03
CLS_DRIFT = 0.062                        # int8 preset vs exact bf16: mean |d CLS| < 0.062 * max |CLS|
BATCH, SEQ, LONG_SEQ, CANVAS, LABELS = 32, 128, 256, 256, 7
SEQ512 = 512
VOCAB = 30522
HD, HEADS, DI = 768, 12, 3072
# bn_stats vs its two-pass plain version: float32 sums in another order; a
# mean near zero has no relative precision, so the atol scales with the data
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6      # atol * E|x| on the mean, * E[x^2] on the variance
# bf16 training step against a float32 twin on the same weights and batch, dropout 0
MIXED_LOSS_REL, MIXED_GRAD_COS = 2e-2, 0.99
BN_AB_LOSS_REL = 1e-2                    # bn_stats kernel vs cuDNN BatchNorm, one step's loss
F32_FRAC = 1e-4                          # float32 kernels vs plain: max |d| <= 1e-4 * max |plain|
# the flash backward kernels vs their plain versions: p and ds are rounded to bf16 from the
# kernel's own float32 scores, so a rounding apart moves a gradient by a bf16 step of its largest term
GRAD_FRAC, GRAD_MEAN = 0.02, 2e-3
FLASH_LOSS_REL, FLASH_GRAD_COS = 1e-2, 0.99  # a flash training step vs the same step on the plain flash op
# A baseline model with a float32 kernel vs the same weights with its plain op: the
# two agree to ~1e-6 relative, which flips a bf16 rounding now and then downstream
# (the scan's and each KAN layer's outputs are cast to bf16, the MLP head's logits
# are bf16): max |d| within two bf16 steps of the largest logit (2^-6 of it), mean
# |d| within 2^-10 of it. Relative, as the two heads' logits differ in scale by 10^3.
BF16_STEPS, BF16_MEAN = 2.0 ** -6, 2.0 ** -10
# The train phase's ResNet50 takes each bottleneck's last BatchNorm scale at
# 0.1: with every scale at 1 (the seeded init) a training-mode ResNet50 is
# chaotic, so a bf16 step and a float32 step differ by the weights'
# conditioning, not by their arithmetic (the phase reports that comparison
# too: "seeded_init"; the JAX package's own bf16 step reads as low on these
# weights, tests/test_torch_port_mixed_precision.py). A trained ResNet's
# residual branches are damped (torchvision's zero_init_residual takes them to 0).
RESIDUAL_BN_SCALE = 0.1
# H100 SXM datasheet peaks at 700 W: bytes/s of HBM, dense ops/s (float32 outside the tensor cores)
HBM_BPS, BF16_OPS, INT8_OPS, F32_OPS = 3.35e12, 989e12, 1979e12, 67e12

KERNELS = {  # name: (module, source, TPU kernel it replaces)
    "attention_block": (ab.attention_block, "mdhs_tpu_torch/csrc/attention_block.cu",
                        "mdhs_tpu/ops/attention_block.py:110"),
    "ffn_block": (fb.ffn_block, "mdhs_tpu_torch/csrc/ffn_block.cu", "mdhs_tpu/ops/ffn_block.py:80"),
    "fused_attention": (fa.fused_attention, "mdhs_tpu_torch/csrc/fused_attention.cu",
                        "mdhs_tpu/ops/fused_attention.py:103"),
    "int8_ffn_block": (qk.int8_ffn_block, "mdhs_tpu_torch/csrc/int8_ffn_block.cu",
                       "mdhs_tpu/ops/quant_kernel.py:97"),
    "int8_attention_block": (qk.int8_attention_block, "mdhs_tpu_torch/csrc/int8_attention_block.cu",
                             "mdhs_tpu/ops/quant_kernel.py:230"),
    "shear_sublane": (sh.shear_sublane, "mdhs_tpu_torch/csrc/shear.cu", "mdhs_tpu/ops/shear.py:93"),
    "bn_stats": (bns.bn_stats, "mdhs_tpu_torch/csrc/bn_stats.cu", "mdhs_tpu/ops/bn_stats.py:138"),
    "selective_scan": (ss.selective_scan, "mdhs_tpu_torch/csrc/selective_scan.cu",
                       "mdhs_tpu/ops/selective_scan.py:112"),
    "kan_forward": (ks.kan_forward, "mdhs_tpu_torch/csrc/kan_spline.cu", "mdhs_tpu/ops/kan_spline.py:114"),
    # the library kernels mdhs_tpu/models/bert.py:207 calls under attention_impl="flash" (jax 0.9.0)
    "flash_attention": (fl.flash_attention_forward, "mdhs_tpu_torch/csrc/flash_attention.cu",
                        "jax/experimental/pallas/ops/tpu/flash_attention.py:758"),
    "flash_attention_bwd_dkv": (fl.flash_attention_bwd_dkv, "mdhs_tpu_torch/csrc/flash_attention.cu",
                                "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "flash_attention_bwd_dq": (fl.flash_attention_bwd_dq, "mdhs_tpu_torch/csrc/flash_attention.cu",
                               "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
    # the ablation diagnostic's kernel, make_kernel (:27) reached through build(mode).op
    "attention_ablate": (aa.attention_ablate, "mdhs_tpu_torch/csrc/attention_ablate.cu",
                         "benchmarks/attention_ablate.py:67"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def zero_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def diff(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs()
    return d.max().item(), d.mean().item()


# kernel family <- name fragments, first match wins (cuDNN's implicit-GEMM
# convolutions are "fprop" kernels, so they are tested before cuBLAS's GEMMs;
# fused_attention_kernel before attention_kernel, the s8 GEMMs before both)
_FAMILIES = {
    "flash_attention_kernels": ("flash_forward_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"),
    "selective_scan_kernel": ("selective_scan_kernel",),
    "kan_forward_kernel": ("kan_forward_kernel",),
    "shear_kernel": ("shear_sublane_kernel",),
    "bn_stats_kernel": ("bn_stats_",),
    "gemm_s8_residual_ln_kernel": ("gemm_s8_residual_ln_kernel",),
    "gemm_s8_kernel": ("gemm_s8_kernel",),
    "row_quantize_kernel": ("row_quantize_kernel",),
    "gemm_residual_ln_kernel": ("gemm_residual_ln_kernel",),
    "gemm_bias_kernel": ("gemm_bias_kernel",),
    "fused_attention_kernel": ("fused_attention_kernel",),
    "attention_kernel": ("attention_kernel",),
    "cudnn_conv": ("fprop", "dgrad", "wgrad", "conv"),
    "batch_norm": ("batch_norm",),
    "cublas_gemm": ("nvjet", "gemm", "cublas"),
    # PyTorch's own kernels, which the training step adds
    "layer_norm": ("layer_norm",),
    "softmax": ("softmax",),
    "dropout": ("dropout",),
    "optimizer_foreach": ("multi_tensor_apply",),
    "elementwise": ("elementwise",),
    "reduce": ("reduce_kernel",),
    "copy_cat": ("copy", "cat"),
}


def _device_kernels(fn, reps: int) -> list:
    """(name, device ms per call, launches per call) of every CUDA kernel fn
    runs, from torch.profiler over ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # a user annotation (torch.optim's "Optimizer.step#Adam.step") spans kernels counted on their own
    return [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def device_profile(fn, forward_ms: float, reps: int = 3, top: int = 0) -> dict:
    """Device time per call by kernel family (torch.profiler, CUDA events
    only), its share of the unprofiled CUDA-event time of the call, and the
    ``top`` kernels by device time."""
    kernels = _device_kernels(fn, reps)
    by = dict.fromkeys([*_FAMILIES, "other"], 0.0)
    for name, ms, _ in kernels:
        low = name.lower()
        by[next((f for f, frags in _FAMILIES.items() if any(x in low for x in frags)), "other")] += ms
    busy = sum(by.values())
    out = {"kernel_ms": busy, "busy_share": busy / forward_ms, "by_family_ms": by}
    if top:
        out["top_kernels"] = [{"name": n[:120], "ms": ms, "launches": c}
                              for n, ms, c in sorted(kernels, key=lambda k: -k[1])[:top]]
    return out


def kernel_device_ms(fn, reps: int = 10) -> float:
    """Device time of one call (the sum of its kernels' times), without the
    host's launch overhead that CUDA events around a short call include."""
    return sum(ms for _, ms, _ in _device_kernels(fn, reps))


# --- bounds: the least time the card could take for each kernel's work -------
def _bound(bytes_moved: float, ops_s: float) -> tuple[float, str]:
    mem_s = bytes_moved / HBM_BPS
    return max(mem_s, ops_s) * 1e3, "bytes" if mem_s >= ops_s else "operations"


def bound_attention_block(B, L):
    M, D = B * L, HD // HEADS
    flops = 2 * M * HD * 3 * HD + 4 * B * HEADS * L * L * D + 2 * M * HD * HD
    nbytes = 2 * (2 * M * HD) + 2 * (4 * HD * HD + 6 * HD) + 4 * B * L
    return _bound(nbytes, flops / BF16_OPS)


def bound_ffn_block(N):
    nbytes = 2 * (2 * N * HD) + 2 * (2 * HD * DI + DI + 3 * HD)
    return _bound(nbytes, 4 * N * HD * DI / BF16_OPS)


def bound_int8_ffn_block(N):
    nbytes = 2 * (2 * N * HD) + 2 * HD * DI + 4 * (2 * DI + 4 * HD)
    return _bound(nbytes, 4 * N * HD * DI / INT8_OPS)


def bound_int8_attention_block(B, L):
    M, D = B * L, HD // HEADS
    ops_s = 8 * M * HD * HD / INT8_OPS + 4 * B * HEADS * L * L * D / BF16_OPS
    nbytes = 2 * (2 * M * HD) + 4 * HD * HD + 4 * (6 * HD + 4 * HD) + 4 * B * L
    return _bound(nbytes, ops_s)


def bound_fused_attention(B, L):
    D = HD // HEADS
    return _bound(2 * (4 * B * L * HD) + 4 * B * L, 4 * B * HEADS * L * L * D / BF16_OPS)


def bound_attention_ablate(mode, B, L):
    # what each mode does: full, nomax, nosmax read q, k, v and the bias and write ctx, with
    # Q K^T and P V; nopv reads no V and does no P V; aligned reads one head of q, k, v and
    # writes its D columns, but computes every head's products
    tensor = 2 * B * L * HD  # one (B, L, HD) bf16 tensor
    tensors, products = {"nopv": (3, 1), "aligned": (4 / HEADS, 2)}.get(mode, (4, 2))
    return _bound(tensors * tensor + 4 * B * L, products * 2 * B * HEADS * L * L * (HD // HEADS) / BF16_OPS)


def _flash_bound(B, L, operands, stats, products):
    # ``operands`` (B, L, HD) bf16 tensors read or written once, the int32 segment ids,
    # ``stats`` (B, heads, L) float32 rows, ``products`` (B, heads, L, L, D) matrix products
    nbytes = 2 * operands * B * L * HD + 4 * B * L + 4 * stats * B * HEADS * L
    return _bound(nbytes, products * 2 * B * HEADS * L * L * (HD // HEADS) / BF16_OPS)


def bound_flash_forward(B, L, stats=False):
    # q, k, v read, o written (and m, l when the backward needs them); S and P V
    return _flash_bound(B, L, 4, 2 if stats else 0, 2)


def bound_flash_dkv(B, L):
    return _flash_bound(B, L, 6, 3, 4)  # q, k, v, do read, dk, dv written; m, l, di; S, dP, dV, dK


def bound_flash_dq(B, L):
    # q, k, v, o, do read, dq written; m, l read, di written (taken from o and do); S, dP, dQ
    return _flash_bound(B, L, 6, 3, 3)


def bound_shear(B, C, S, L, pad):
    # output column r reads rows s_r .. s_r + W of its plane: W + 1 of the S padded rows
    W = S - 2 * pad
    return _bound(4 * (B * C * (W + 1) * L + B * C * W * L + B * L), 3 * B * C * W * L / F32_OPS)


def bound_bn_stats(R, C, itemsize):
    return _bound(R * C * itemsize + 8 * C, 5 * R * C / F32_OPS)


def bound_selective_scan(B, L, D, N):
    # x, dt read and y written (B, L, D); A (D, N); B, C (B, L, N); D_skip. A step
    # of one state: dt * A, exp, the decay product and the drive (2), the C product and sum (2)
    nbytes = 4 * (3 * B * L * D + D * N + 2 * B * L * N + D)
    return _bound(nbytes, 7 * B * L * D * N / F32_OPS)


# The bases of one (row, input) on 12 knots, order 3: 11 interval tests (3 operations
# each), then the 2 + 3 + 4 combinations that have a nonzero term (of the full
# recursion's 10 + 9 + 8; the rest are exactly 0), 9 operations each (4
# subtractions, 2 divisions, 2 products, 1 sum); silu 4
KAN_BASIS_OPS = 3 * 11 + 9 * (2 + 3 + 4) + 4


def bound_kan_forward(E, B, IN, OUT, shared):
    # x read once (once for all experts when shared), grid, Wb, Ws (C = 8), y written;
    # the product 2 * (C + 1) a (row, input, output) and the bases of each x once
    rows = B if shared else E * B
    nbytes = 4 * (rows * IN + E * IN * 12 + E * OUT * IN * 9 + E * B * OUT)
    return _bound(nbytes, (2 * 9 * E * B * IN * OUT + KAN_BASIS_OPS * rows * IN) / F32_OPS)


# ---------------------------------------------------------------------------
def phase_device() -> tuple[torch.device, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index]
    emit({"phase": "device", "name": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev, smi


def _ptxas(log: str, fragments: tuple) -> dict:
    """Registers, stack and spills of each kernel whose mangled name holds one
    of ``fragments``, from the build's ``-Xptxas=-v`` log, and whether ptxas
    serialized its wgmma pipeline (C7515, "Potential Performance Loss").
    A kernel is named with its template arguments: attention_ablate_kernel<1,3>
    is one 64-column chunk, mode 3 of ops/attention_ablate.py::MODES (nopv)."""
    def short(mangled):
        k = re.search(r"\d+([a-z_]+_kernel)I((?:Li\d+E)+)E", mangled)
        if not k:
            return mangled
        args = ",".join(re.findall(r"Li(\d+)E", k.group(2)))
        return f"{k.group(1)}<{args}>"

    def wanted(mangled):
        return any(f in mangled for f in fragments)

    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = short(m.group(1)) if wanted(m.group(1)) else None
            if name:
                out.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    for line in log.splitlines():
        if "C7515" in line and (m := re.search(r"function '(\w+)'", line)) and wanted(m.group(1)):
            out.setdefault(short(m.group(1)), {})["wgmma_serialized"] = True
    return out


def phase_build() -> None:
    path, seconds = _build.build()
    _build.load_library()
    emit({"phase": "build", "library": str(path.relative_to(_build.BUILD_DIR.parent.parent)),
          "seconds": seconds})
    # the attention kernels' ptxas report: the consumers run at setmaxnreg 240, the producer at 24
    emit({"phase": "build", "ptxas_attention": _ptxas(Path(str(path) + ".log").read_text(),
                                                      ("flash_", "fused_attention_kernel", "attention_ablate_kernel"))})


def _rand(rng, shape, scale, dev):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.bfloat16, device=dev)


def _rand_f32(rng, shape, scale, dev, offset=0.0):
    return torch.tensor(offset + rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)


def _key_bias(B, L, n_pad, dev):
    mask = np.ones((B, L), np.float32)
    mask[:, L - n_pad:] = 0.0  # the last n_pad keys of each row are padding
    return torch.tensor((1.0 - mask) * -1e9, device=dev)


def _segment_ids(rng, B, L, dev):
    """int32 (B, L) attention masks as requests carry them (real prefixes of L/8 to L
    tokens), with one row mostly padding and one whose second segment's keys lie
    only in the last tile."""
    lengths = rng.integers(L // 8, L + 1, B)
    seg = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    seg[0] = 1
    seg[1, 3:] = 0
    seg[2] = 0
    seg[2, L - 10:] = 1
    return torch.from_numpy(seg).to(dev)


def judge_bf16(out, ref):
    mx, mean = diff(out, ref)
    return mx, mean, MAX_ABS, mx <= MAX_ABS and mean < MEAN_ABS


def judge_flash(out, ref):
    """The flash forward with its statistics: o within the bf16 bound, m and l
    within atol 1e-3 and rtol 1e-4 (tests/test_torch_port_cuda.py)."""
    (o, m, l), (o_ref, m_ref, l_ref) = out, ref
    mx, mean, bound, ok = judge_bf16(o, o_ref)
    stats_ok = all(torch.allclose(a, b, atol=1e-3, rtol=1e-4) for a, b in ((m, m_ref), (l, l_ref)))
    return mx, mean, bound, ok and stats_ok


def judge_int8(out, ref):
    mx, mean = diff(out, ref)
    bound = INT8_FRAC * ref.float().abs().max().item()
    return mx, mean, bound, mx <= bound and mean < MEAN_ABS


def judge_f32(out, ref):
    mx, mean = diff(out, ref)
    bound = F32_FRAC * ref.float().abs().max().item()
    return mx, mean, bound, mx <= bound


def judge_grad(out, ref):
    """dQ, dK, dV: max |d| <= GRAD_FRAC * max |plain|, mean |d| <= GRAD_MEAN * max |plain|."""
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    mx = mean = bound = 0.0
    ok = True
    for o, r in zip(outs, refs):
        d_max, d_mean = diff(o, r)
        scale = r.float().abs().max().item()
        ok = ok and d_max <= GRAD_FRAC * scale and d_mean <= GRAD_MEAN * scale
        mx, mean, bound = max(mx, d_max), max(mean, d_mean), max(bound, GRAD_FRAC * scale)
    return mx, mean, bound, ok


def judge_dq(o, do):
    """The dQ kernel's (dq, di): dq as judge_grad; di within 2 D 2^-24 * sum |o * do| of
    its row (each bf16 product is exact in float32, so the sums differ only in order)."""
    bound = 2 * (HD // HEADS) * 2.0 ** -24 * fl.attention_di(o.abs(), do.abs(), HEADS)

    def judge(out, ref):
        mx, mean, max_bound, ok = judge_grad(out[0], ref[0])
        d = (out[1] - ref[1]).abs()
        ok = ok and out[1].dtype == torch.float32 and bool((d <= bound).all())
        return max(mx, d.max().item()), mean, max_bound, ok

    return judge


def judge_exact(out, ref):
    mx, mean = diff(out, ref)
    return mx, mean, 0.0, mx == 0.0


def judge_stats(x):
    """bn_stats' (mean, var) against the plain version's: rtol STATS_RTOL and
    atol STATS_ATOL * E|x| (mean) or * E[x^2] (variance), element by element."""
    xf = x.float()
    atols = (STATS_ATOL * xf.abs().mean().item(), STATS_ATOL * xf.square().mean().item())

    def judge(out, ref):
        ok, mx, mean, bound = True, 0.0, 0.0, 0.0
        for o, r, atol in zip(out, ref, atols):
            d = (o - r).abs()
            ok = ok and bool((d <= atol + STATS_RTOL * r.abs()).all())
            mx, mean = max(mx, d.max().item()), max(mean, d.mean().item())
            bound = max(bound, atol + STATS_RTOL * r.abs().max().item())
        return mx, mean, bound, ok

    return judge


def _shear_case(rng, B, pad, max_degrees, axis, dev):
    """A shear_sublane input as rotate_3shear makes it: (B, 3, 224 + 2 pad, 224)
    with a zero border, and d = tan(angle / 2) * idx (the W shears) or
    -sin(angle) * idx (the H shear)."""
    O = 224
    x = torch.zeros((B, 3, O + 2 * pad, O), dtype=torch.float32)
    x[:, :, pad:pad + O] = torch.from_numpy(rng.random((B, 3, O, O), dtype=np.float32))
    ang = np.radians(rng.uniform(-max_degrees, max_degrees, (B, 1)))
    slope = np.tan(ang / 2) if axis == "w" else -np.sin(ang)
    d = (slope * (np.arange(O) - (O - 1) / 2.0)).astype(np.float32)
    x, d = x.to(dev), torch.from_numpy(d).to(dev)
    # the same function as one grid_sample call: column r exactly, row v + pad + d[r] (timing only)
    S = O + 2 * pad
    cols = (2.0 * torch.arange(O, device=dev) / (O - 1) - 1.0).expand(B, O, O)
    rows = 2.0 * (torch.arange(O, device=dev)[None, :, None] + pad + d[:, None, :]) / (S - 1) - 1.0
    grid = torch.stack([cols, rows], dim=-1)
    library = lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)  # noqa: E731
    return (x, d, pad), library


def _sdpa_calls(q, k, v, seg, do):
    """SDPA's forward with the boolean segment mask, and its backward alone:
    autograd.grad through one saved forward graph (timing only)."""
    B, L, _ = q.shape
    heads = [t.view(B, L, HEADS, HD // HEADS).transpose(1, 2) for t in (q, k, v)]
    keep = (seg[:, :, None] == seg[:, None, :])[:, None]
    leaves = [t.detach().requires_grad_() for t in heads]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep, scale=0.125)
    do_heads = do.view(B, L, HEADS, HD // HEADS).transpose(1, 2)
    forward = lambda: F.scaled_dot_product_attention(*heads, attn_mask=keep, scale=0.125)  # noqa: E731
    backward = lambda: torch.autograd.grad(out, leaves, do_heads, retain_graph=True)  # noqa: E731
    return forward, backward


def _kernel_cases(dev, rng):
    """(name, shape, plain, args, main path?, (bound_ms, bound_by), library call or None, judge)."""
    cases = []
    for B, L in ((8, 128), (8, 256), (BATCH, SEQ)):
        args = (_rand(rng, (B, L, HD), 1.0, dev), _rand(rng, (3 * HD, HD), 0.03, dev),
                _rand(rng, (3 * HD,), 0.01, dev), _rand(rng, (HD, HD), 0.03, dev), _rand(rng, (HD,), 0.01, dev),
                (1.0 + _rand(rng, (HD,), 0.1, dev)).contiguous(), _rand(rng, (HD,), 0.1, dev),
                _key_bias(B, L, 28, dev), HEADS, 0.125, 1e-12)
        cases.append(("attention_block", f"B={B},L={L}", ab.attention_block_reference, args,
                      (B, L) == (BATCH, SEQ), bound_attention_block(B, L), None, judge_bf16))
    for N in (128, BATCH * SEQ):
        for act in ("erf", "tanh"):
            args = (_rand(rng, (N, HD), 1.0, dev), _rand(rng, (DI, HD), 0.03, dev),
                    _rand(rng, (DI,), 0.01, dev), _rand(rng, (HD, DI), 0.03, dev),
                    _rand(rng, (HD,), 0.01, dev), (1.0 + _rand(rng, (HD,), 0.1, dev)).contiguous(),
                    _rand(rng, (HD,), 0.1, dev), 1e-12, act)
            cases.append(("ffn_block", f"N={N},act={act}", fb.ffn_block_reference, args,
                          (N, act) == (BATCH * SEQ, "erf"), bound_ffn_block(N), None, judge_bf16))
    P = MIBF_HAM_SERVING.batch_size
    for N in (128, P * SEQ):
        for act in ("erf", "tanh"):  # the preset's fast_math takes tanh
            w1, s1 = quantize_weight(_rand(rng, (DI, HD), 0.03, dev))
            w2, s2 = quantize_weight(_rand(rng, (HD, DI), 0.03, dev))
            args = (_rand(rng, (N, HD), 1.0, dev), w1, s1, _rand_f32(rng, (DI,), 0.01, dev), w2, s2,
                    _rand_f32(rng, (HD,), 0.01, dev), _rand_f32(rng, (HD,), 0.1, dev, 1.0),
                    _rand_f32(rng, (HD,), 0.1, dev), 1e-12, act)
            cases.append(("int8_ffn_block", f"N={N},act={act}", qk.int8_ffn_block_reference, args,
                          (N, act) == (P * SEQ, "tanh"), bound_int8_ffn_block(N), None, judge_int8))
    for B, L in ((8, 128), (8, LONG_SEQ), (P, SEQ)):
        wqkv, sqkv = quantize_weight(_rand(rng, (3 * HD, HD), 0.03, dev))
        wo, so = quantize_weight(_rand(rng, (HD, HD), 0.03, dev))
        args = (_rand(rng, (B, L, HD), 1.0, dev), wqkv, sqkv, _rand_f32(rng, (3 * HD,), 0.01, dev), wo, so,
                _rand_f32(rng, (HD,), 0.01, dev), _rand_f32(rng, (HD,), 0.1, dev, 1.0),
                _rand_f32(rng, (HD,), 0.1, dev), _key_bias(B, L, 28, dev), HEADS, 0.125, 1e-12)
        cases.append(("int8_attention_block", f"B={B},L={L}", qk.int8_attention_block_reference, args,
                      (B, L) == (P, SEQ), bound_int8_attention_block(B, L), None, judge_int8))
    for B, L in ((8, 384), (8, 500), (8, SEQ512), (BATCH, SEQ512)):
        q, k, v = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(3))
        bias = _key_bias(B, L, L // 5, dev)
        args = (q, k, v, bias, HEADS, 0.125)
        heads = [t.view(B, L, HEADS, HD // HEADS).transpose(1, 2) for t in (q, k, v)]
        keep = (bias == 0)[:, None, None, :]
        library = lambda h=heads, m=keep: F.scaled_dot_product_attention(*h, attn_mask=m, scale=0.125)  # noqa: E731
        cases.append(("fused_attention", f"B={B},L={L}", fa.attention_reference, args,
                      (B, L) == (BATCH, SEQ512), bound_fused_attention(B, L), library, judge_bf16))
    # BERT's flash core: the forward at the flash serving shape (batch 32, seq 512), a ragged seq
    # 200 and the training shape (32, 256) with the statistics the backward reads, the two backward
    # kernels at both full shapes. The library call is SDPA with the boolean segment mask: its
    # forward for the forward, and for each backward kernel SDPA's backward alone (autograd.grad on
    # a saved forward graph), which makes dQ, dK and dV together: one yardstick for the pair
    for B, L, kinds in ((8, 200, ("forward",)), (BATCH, SEQ512, ("forward", "dkv", "dq")),
                        (BATCH, LONG_SEQ, ("forward", "dkv", "dq"))):
        q, k, v, do = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(4))
        seg = _segment_ids(rng, B, L, dev)
        o, m, l = fl.flash_attention_reference(q, k, v, seg, HEADS, 0.125, save_stats=True)
        dkv_args = (q, k, v, seg, m, l, do, fl.attention_di(o, do, HEADS), HEADS, 0.125)
        dq_args = (q, k, v, seg, o, m, l, do, HEADS, 0.125)
        sdpa, sdpa_backward = _sdpa_calls(q, k, v, seg, do)
        stats = (B, L) == (BATCH, LONG_SEQ)  # the training step's forward saves m and l
        for kind in kinds:
            if kind == "forward":
                cases.append(("flash_attention", f"B={B},L={L}" + (",stats" if stats else ""),
                              fl.flash_attention_reference, (q, k, v, seg, HEADS, 0.125, stats),
                              (B, L) == (BATCH, SEQ512), bound_flash_forward(B, L, stats), sdpa,
                              judge_flash if stats else judge_bf16))
            elif kind == "dkv":
                cases.append(("flash_attention_bwd_dkv", f"B={B},L={L}", fl.flash_attention_bwd_dkv_reference,
                              dkv_args, (B, L) == (BATCH, LONG_SEQ), bound_flash_dkv(B, L), sdpa_backward,
                              judge_grad))
            else:
                cases.append(("flash_attention_bwd_dq", f"B={B},L={L}", fl.flash_attention_bwd_dq_reference,
                              dq_args, (B, L) == (BATCH, LONG_SEQ), bound_flash_dq(B, L), sdpa_backward,
                              judge_dq(o, do)))
    # the training step's rotation: pads 17 (W shears) and 31 (H shear) at 15 degrees, batch 32;
    # the baseline family's 45 degrees (pads 49 / 82) on a smaller batch
    for B, pad, deg, axis in ((BATCH, 17, 15.0, "w"), (BATCH, 31, 15.0, "h"), (8, 49, 45.0, "w"), (8, 82, 45.0, "h")):
        args, library = _shear_case(rng, B, pad, deg, axis, dev)
        x = args[0]
        cases.append(("shear_sublane", f"x={tuple(x.shape)},pad={pad}", sh.shear_reference, args, pad == 17,
                      bound_shear(*x.shape, pad), library, judge_exact))
    # ResNet50's BatchNorm inputs at batch 32, channels-last rows, bf16: stem, layer1 (bn3), layer4 (bn3)
    for R, C in ((BATCH * 112 * 112, 64), (BATCH * 56 * 56, 256), (BATCH * 7 * 7, 2048)):
        x = (torch.randn((R, C), device=dev, generator=torch.Generator(device=dev).manual_seed(R + C)) * 2.0
             + 0.5).to(torch.bfloat16)
        library = lambda x=x: torch.var_mean(x, dim=0, unbiased=False)  # noqa: E731
        cases.append(("bn_stats", f"R={R},C={C},bf16", bns.bn_stats_reference, (x,), C == 64,
                      bound_bn_stats(R, C, 2), library, judge_stats(x)))
    # the Mamba fusion's scan at batch 64: 49 layer4 tokens, d_inner 512, N 16; and the
    # gate's other state sizes (MambaVision's N 8, the multimodal Mamba fusion's N 128)
    for B, L, D, N in ((BASELINE_BATCH, 49, 512, 16), (BASELINE_BATCH, 196, 320, 8), (16, 64, 512, 128)):
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        args = (f(rng.standard_normal((B, L, D))), f(np.log1p(np.exp(rng.standard_normal((B, L, D)) - 2.0))),
                -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(D, N).contiguous(),
                f(rng.standard_normal((B, L, N))), f(rng.standard_normal((B, L, N))), f(np.ones(D)))
        cases.append(("selective_scan", f"B={B},L={L},D={D},N={N}", ss.selective_scan_reference, args, N == 16,
                      bound_selective_scan(B, L, D, N), None, judge_f32))
    # the MoE head's KAN bank at batch 64: 4 experts, layer 0 (256 -> 1024, x shared) and layer 1 (1024 -> 7)
    E, H = HAM_HEAD_MOE.moe_num_experts, HAM_HEAD_MOE.hidden_dim
    for IN, OUT, shared in ((H, 4 * H, True), (4 * H, HAM_HEAD_MOE.num_classes, False)):
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        x = f(rng.standard_normal((BASELINE_BATCH, IN) if shared else (E, BASELINE_BATCH, IN)) * 0.7)
        args = (x, make_grid(IN, 5, 3, device=dev).expand(E, IN, 12).contiguous(),
                f(rng.uniform(-1, 1, (E, OUT, IN)) / np.sqrt(IN)), f(rng.standard_normal((E, OUT, IN, 8)) * 0.01))
        cases.append(("kan_forward", f"E={E},x={tuple(x.shape)},OUT={OUT}", ks.kan_forward_reference, args, shared,
                      bound_kan_forward(E, BASELINE_BATCH, IN, OUT, shared), None, judge_f32))
    return cases


def _flash_backward_pair(dev, rng) -> None:
    """The port's whole flash backward (FlashAttention.backward: dQ, which takes
    di, then dK/dV) against SDPA's backward alone at the training shape (32, 256)
    and at seq 512, device time of each by the profiler (timing only). The
    parent's line timed di (attention_di, torch), dK/dV and dQ; di is inside dQ
    now, so the whole backward is the same work, and attention_di's own device
    time is printed beside it."""
    for B, L in ((BATCH, LONG_SEQ), (BATCH, SEQ512)):
        q, k, v, do = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(4))
        seg = _segment_ids(rng, B, L, dev)
        o, m, l = fl.flash_attention_forward(q, k, v, seg, HEADS, 0.125, save_stats=True)

        def port():
            _, di = fl.flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, HEADS, 0.125)
            fl.flash_attention_bwd_dkv(q, k, v, seg, m, l, do, di, HEADS, 0.125)

        _, sdpa_backward = _sdpa_calls(q, k, v, seg, do)
        emit({"phase": "kernels", "kernel": "flash_attention backward (dQ with di + dK/dV)",
              "parent_definition": "di (attention_di, torch) + dK/dV + dQ", "shape": f"B={B},L={L}",
              "ms": cuda_ms(port), "device_ms": kernel_device_ms(port),
              "attention_di_device_ms": kernel_device_ms(lambda: fl.attention_di(o, do, HEADS)),
              "bound_ms": bound_flash_dkv(B, L)[0] + bound_flash_dq(B, L)[0], "library_ms": cuda_ms(sdpa_backward),
              "library_device_ms": kernel_device_ms(sdpa_backward), "library": "SDPA backward alone"})


def phase_kernels(dev, rng) -> dict:
    """Each kernel against its plain version; returns per-kernel summaries."""
    summary = {}
    for name, shape, plain, args, main_path, (bound_ms, bound_by), library, judge in _kernel_cases(dev, rng):
        kernel = KERNELS[name][0]
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        outs = out if isinstance(out, tuple) else (out,)
        check(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"{name} {shape}: non-finite output")
        mx, mean, max_bound, ok = judge(out, ref)
        check(ok, f"{name} {shape}: max|d|={mx} mean|d|={mean} beyond {max_bound}")
        ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
        library_ms = cuda_ms(library) if library is not None else None
        device_ms = kernel_device_ms(lambda: kernel(*args))
        library_device_ms = kernel_device_ms(library) if library is not None else None
        emit({"phase": "kernels", "kernel": name, "shape": shape, "max_abs_err": mx, "mean_abs_err": mean,
              "max_abs_bound": max_bound, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
              "library_device_ms": library_device_ms})
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], mx)
        if main_path:
            s.update(shape=shape, ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms, library_device_ms=library_device_ms)
        del out, ref
    _flash_backward_pair(dev, rng)
    # bn_stats' backward (the analytic VJP) against autograd through the plain version,
    # float32 at layer1's bn3 input
    x0 = torch.randn((BATCH * 56 * 56, 256), device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    w = torch.randn(256, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    grads = []
    for fn in (bns.bn_stats, bns.bn_stats_reference):
        x = x0.clone().requires_grad_()
        m, v = fn(x)
        (torch.sum(w * m) + torch.sum(torch.sqrt(v + 1e-5))).backward()
        grads.append(x.grad)
    d = (grads[0] - grads[1]).abs()
    scale = grads[1].abs().max().item()
    check(bool((d <= 1e-5 * scale + 1e-4 * grads[1].abs()).all()), f"bn_stats backward: max|d|={d.max().item()}")
    emit({"phase": "kernels", "kernel": "bn_stats", "shape": f"backward R={x0.shape[0]},C=256,f32",
          "max_abs_err": d.max().item(), "max_abs_bound": 1e-5 * scale})
    del x0, grads, d
    torch.cuda.empty_cache()
    return summary


def judge_rel(out, ref, mode):
    """An ablated mode against its plain version. nopv writes bf16 probabilities
    rounded as the plain version rounds them: each within one bf16 ulp of its own,
    |d| <= 2^-7 |p| + 2^-24. The others: the bf16 bound on |d| over each (batch,
    query) row's own max(1, max |plain|), since nosmax's outputs reach 1e10 in a
    row with padded keys and about 10 in a row without. Returns max |d|, and the
    worst share of its bound and the mean of |d| over the row scale beside the
    bf16 mean bound."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    if mode == "nopv":
        used = (d / (2.0 ** -7 * r.abs() + 2.0 ** -24)).max().item()
        return {"max_abs": d.max().item(), "bound_used": used}, used <= 1.0
    rel = d / r.abs().amax(-1, keepdim=True).clamp_min(1.0)
    used, mean = rel.max().item() / MAX_ABS, rel.mean().item()
    return {"max_abs": d.max().item(), "bound_used": used, "mean_row_rel": mean}, used <= 1.0 and mean < MEAN_ABS


def phase_ablate(dev, rng) -> tuple[dict, int]:
    """The attention ablation at the TPU script's shape (B 256, L 128, 12 heads
    of 64): each mode's kernel against its plain version, with zero bias (the
    diagnostic's) and with a bias that pads keys in the even rows and is finite
    noise in the odd ones (judge_rel); full against fused_attention and aligned
    against full, bit for bit; each mode's times and bound on the zero bias. Then the main path, the diagnostic's own chains (diagnostics/
    attention_ablate.py::run), between zero_counts and read_counts: the count is
    the wrapper's calls, each chain's warm-up and capture and its profiled eager
    run (a graph replay launches the captured kernels without the wrapper).
    Returns full's summary for the kernels line and the main path's launches."""
    B, L, D, scale = diag.B, diag.L, HD // HEADS, diag.SCALE
    q, k, v = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(3))
    zero = torch.zeros((B, L), dtype=torch.float32, device=dev)
    mixed = _key_bias(B, L, 28, dev)  # even rows: the last 28 keys padded; odd rows: a finite N(0, 1) bias
    mixed[1::2] = torch.tensor(np.random.default_rng(1).standard_normal((B // 2, L)), device=dev)
    biases = {"zero": zero, "padding_and_noise": mixed}
    full = {name: fa.fused_attention(q, k, v, bias, HEADS, scale) for name, bias in biases.items()}
    summary = None
    for mode in aa.MODES:
        cols = slice(0, D) if mode == "aligned" else slice(None)  # aligned writes head 0's D columns only
        errs = {}
        for name, bias in biases.items():
            args = (q, k, v, bias, HEADS, scale, mode)
            out = aa.attention_ablate(*args)
            torch.cuda.synchronize()
            errs[name], ok = judge_rel(out[..., cols], aa.attention_ablate_reference(*args)[..., cols], mode)
            check(ok and bool(torch.isfinite(out[..., cols].float()).all()),
                  f"attention_ablate {mode} {name}: {errs[name]} beyond its bound")
            if mode == "full":
                check(torch.equal(out, full[name]), f"attention_ablate full {name}: not fused_attention's bits")
            if mode == "aligned":
                check(torch.equal(out[..., :D], full[name][..., :D]), f"aligned {name}: not full's first head")
        args = (q, k, v, zero, HEADS, scale, mode)
        kernel = lambda a=args: aa.attention_ablate(*a)  # noqa: E731
        library = None
        if mode == "full":  # SDPA with the key mask, as fused_attention's row times it
            heads = [t.view(B, L, HEADS, D).transpose(1, 2) for t in (q, k, v)]
            keep = (zero == 0)[:, None, None, :]
            library = lambda: F.scaled_dot_product_attention(*heads, attn_mask=keep, scale=scale)  # noqa: E731
        bound_ms, bound_by = bound_attention_ablate(mode, B, L)
        row = {"ms": cuda_ms(kernel), "device_ms": kernel_device_ms(kernel),
               "plain_ms": cuda_ms(lambda a=args: aa.attention_ablate_reference(*a), reps=5),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": cuda_ms(library) if library else None,
               "library_device_ms": kernel_device_ms(library) if library else None}
        emit({"phase": "ablate", "mode": mode, "shape": f"B={B},L={L},{HEADS}x{D}", "vs_plain": errs, **row})
        if mode == "full":
            summary = {"max_abs_err": errs["zero"]["max_abs"], **row}
    del full
    # --- the main path: the diagnostic's chains of K_STEPS calls, one CUDA graph a mode
    zero_counts()
    chains = diag.run(q, k, v, zero, HEADS)
    launches = read_counts()
    check(launches["attention_ablate"] > 0 and launches == {**dict.fromkeys(KERNELS, 0),
                                                            "attention_ablate": launches["attention_ablate"]},
          f"ablation chain launches {launches}")
    for row in chains:
        check(row["mode"] == "aligned" or bool(np.isfinite(row["chain_value"])), f"ablation chain {row}")
    emit({"phase": "ablate", "chain": chains, "k_steps": diag.K_STEPS, "launches": launches["attention_ablate"]})
    del q, k, v
    torch.cuda.empty_cache()
    return summary, launches["attention_ablate"]


def _request(rng, n, seq):
    lengths = rng.integers(seq // 8, seq + 1, n)
    lengths[: max(1, n // 4)] = seq  # some rows unpadded, the rest padded
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    ids = rng.integers(1000, VOCAB, (n, seq)) * mask
    ids[:, 0] = 101  # [CLS]
    return {"image": rng.integers(0, 256, (n, CANVAS, CANVAS, 3), dtype=np.uint8),
            "input_ids": ids.astype(np.int64), "attention_mask": mask}


def _bert_out(model, req, dev):
    with torch.inference_mode():
        return model.text_encoder(torch.from_numpy(req["input_ids"]).to(dev),
                                  torch.from_numpy(req["attention_mask"]).to(dev))[0]


def _twin(model, cfg, labels, dev):
    """A model of config ``cfg`` holding ``model``'s weights, in eval mode."""
    twin = MIBFNet(labels, cfg, device=dev, dtype=torch.bfloat16)
    twin.load_state_dict(model.state_dict())
    return twin.eval()


def sync_free(model, request, dev) -> bool:
    """One warm forward of a served path, from device-resident inputs through the
    eval preprocessing, under torch.cuda.set_sync_debug_mode("error"): any call in
    it that makes the host wait on the device raises."""
    inputs = [torch.from_numpy(request[k]).to(dev) for k in ("image", "input_ids", "attention_mask")]

    def forward():
        images = eval_pipeline(inputs[0], 224, normalize=model.normalize_input, dtype=model.input_dtype)
        return model(images, inputs[1], inputs[2])

    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            forward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return True


def _stream_rate(server, requests, n_requests) -> float:
    """images/s of predict_stream (depth 2) over n_requests, host clock."""
    stream = [requests[i % len(requests)] for i in range(n_requests)]
    list(server.predict_stream(iter(stream[:3]), depth=2))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = 0
    for out in server.predict_stream(iter(stream), depth=2):
        rows += out.shape[0]
    return rows / (time.perf_counter() - t0)


def _p50_ms(model, request, dev) -> float:
    one = ServingModel(model, 1, dev)
    single = [{k: v[i:i + 1] for k, v in request.items()} for i in range(8)]
    for r in single[:3]:
        one.predict(r)
    lat = []
    for i in range(40):
        t0 = time.perf_counter()
        one.predict(single[i % len(single)])
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def phase_slice(dev, rng, seed: int):
    cfg = BertConfig()  # BERT-base: 12 layers, 768 wide, 12 heads, 3072 inner, vocab 30522
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_parameters(MIBFNet(LABELS, cfg, device=dev, dtype=torch.bfloat16), g)
    server = ServingModel(model, BATCH, dev)
    requests = [_request(rng, n, SEQ) for n in (BATCH, BATCH, 5)]

    # --- the main path: three requests through predict_stream --------------
    zero_counts()
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = read_counts()
    expect = cfg.num_hidden_layers * len(requests)
    check(launches == {**dict.fromkeys(KERNELS, 0), "attention_block": expect, "ffn_block": expect},
          f"kernel launches {launches}, expected {expect} of attention_block and ffn_block (12 per forward)")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, LABELS), f"logits shape {out.shape}, expected {(n, LABELS)}")
        check(bool(np.isfinite(out).all()), "non-finite logits")

    # --- the same weights on the plain path --------------------------------
    plain = _twin(model, dataclasses.replace(cfg, attention_impl="xla"), LABELS, dev)
    plain_server = ServingModel(plain, BATCH, dev)
    logit_d = [diff(torch.from_numpy(o), torch.from_numpy(plain_server.predict(r)))
               for o, r in zip(outs, requests)]
    bert_d = diff(_bert_out(server.model, requests[0], dev), _bert_out(plain, requests[0], dev))
    check(bert_d[0] <= SLICE_ATOL and bert_d[1] < SLICE_MEAN, f"BERT output fused vs plain: {bert_d}")
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    check(lmax <= SLICE_ATOL and lmean < SLICE_MEAN, f"logits fused vs plain: max {lmax} mean {lmean}")

    # --- one request at seq 256 (configs/mibf/mibf_ham.yml) -----------------
    long_req = _request(rng, 8, LONG_SEQ)
    zero_counts()
    long_out = ServingModel(model, 8, dev).predict(long_req)
    check(read_counts() == {**dict.fromkeys(KERNELS, 0), "attention_block": 12, "ffn_block": 12},
          f"seq-256 forward launches {read_counts()}, expected 12 of attention_block and ffn_block")
    check(long_out.shape == (8, LABELS) and bool(np.isfinite(long_out).all()), "seq-256 logits")
    long_bert_d = diff(_bert_out(server.model, long_req, dev), _bert_out(plain, long_req, dev))
    check(long_bert_d[0] <= SLICE_ATOL and long_bert_d[1] < SLICE_MEAN,
          f"seq-256 BERT output fused vs plain: {long_bert_d}")

    # --- end-to-end rates, host clock around synchronised work ---------------
    images_per_s = _stream_rate(server, requests[:2], 24)
    p50 = _p50_ms(model, requests[0], dev)

    # --- per-layer device times: towers, both BERT paths, kernel breakdown ---
    r = requests[0]
    towers = {}
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=False, dtype=torch.bfloat16)
        ids = torch.from_numpy(r["input_ids"]).to(dev)
        mask = torch.from_numpy(r["attention_mask"]).to(dev)
        for b in (BATCH, 1):
            fwd = lambda: server.model(img[:b], ids[:b], mask[:b])  # noqa: E731
            towers[f"b{b}"] = {
                "resnet_tower_ms": cuda_ms(lambda: server.model.image_encoder(img[:b]), reps=10),
                "bert_tower_ms": cuda_ms(lambda: server.model.text_encoder(ids[:b], mask[:b]), reps=10),
                "bert_tower_plain_ms": cuda_ms(lambda: plain.text_encoder(ids[:b], mask[:b]), reps=10),
                "forward_ms": cuda_ms(fwd, reps=10),
                "forward_plain_ms": cuda_ms(lambda: plain(img[:b], ids[:b], mask[:b]), reps=10),
            }
            towers[f"b{b}"]["device"] = device_profile(fwd, towers[f"b{b}"]["forward_ms"])

    emit({"phase": "slice", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
          "sync_free": sync_free(server.model, requests[0], dev),
          "logits_vs_plain": {"max_abs": lmax, "mean_abs": lmean},
          "bert_out_vs_plain": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "seq256_bert_out_vs_plain": {"max_abs": long_bert_d[0], "mean_abs": long_bert_d[1]},
          "images_per_s_b32_stream": images_per_s, "p50_latency_ms_b1": p50, "towers": towers})
    return launches, model, plain


def _composite_ms(fn) -> float:
    with int8_composite():
        return cuda_ms(fn, reps=5)


def phase_preset(dev, rng, seed: int) -> dict:
    preset = MIBF_HAM_SERVING  # fast_math + int8 BERT-base, batch 512, seq 256, 7 labels
    cfg, P = preset.bert, preset.batch_size
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    model = init_parameters(MIBFNet(preset.num_labels, cfg, device=dev, dtype=torch.bfloat16), g)
    server = ServingModel(model, P, dev)
    requests = [_request(rng, n, SEQ) for n in (P, P, 77)]

    # --- the main path: three requests through predict_stream --------------
    zero_counts()
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = read_counts()
    expect = cfg.num_hidden_layers * len(requests)
    check(launches == {**dict.fromkeys(KERNELS, 0), "int8_attention_block": expect, "int8_ffn_block": expect},
          f"preset launches {launches}, expected {expect} of each int8 kernel and no other (12 per forward)")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, preset.num_labels) and bool(np.isfinite(out).all()), f"preset logits {out.shape}")

    # --- one request at the preset's own seq 256 ----------------------------
    long_req = _request(rng, P, preset.seq_len)
    zero_counts()
    long_out = ServingModel(model, P, dev).predict(long_req)
    check(read_counts() == {**dict.fromkeys(KERNELS, 0), "int8_attention_block": 12, "int8_ffn_block": 12},
          f"preset seq-256 launches {read_counts()}, expected 12 of each int8 kernel")
    check(long_out.shape == (P, preset.num_labels) and bool(np.isfinite(long_out).all()), "preset seq-256 logits")

    # --- the same model on the int8 composite (int8_composite()), and the exact bf16 path
    bert_q = _bert_out(server.model, requests[0], dev)
    long_bert_q = _bert_out(server.model, long_req, dev)
    with int8_composite():
        logit_d = [diff(torch.from_numpy(o), torch.from_numpy(server.predict(r))) for o, r in zip(outs, requests)]
        bert_d = diff(bert_q, _bert_out(server.model, requests[0], dev))
        long_bert_d = diff(long_bert_q, _bert_out(server.model, long_req, dev))
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    for what, (mx, mean) in (("logits", (lmax, lmean)), ("BERT output", bert_d), ("seq-256 BERT output", long_bert_d)):
        check(mx <= INT8_ATOL and mean < INT8_MEAN, f"preset {what} vs int8 composite: max {mx} mean {mean}")
    exact = _twin(model, BertConfig(), preset.num_labels, dev)  # exact-parity bf16, same weights
    cls_e = _bert_out(exact, requests[0], dev)[:, 0].float()
    cls_d = (bert_q[:, 0].float() - cls_e).abs()
    cls_scale = cls_e.abs().max().item()
    check(cls_d.mean().item() < CLS_DRIFT * cls_scale,
          f"preset CLS drift vs exact bf16: mean {cls_d.mean().item()} on max |CLS| {cls_scale}")
    exact_server = ServingModel(exact, P, dev)
    logits_exact_d = diff(torch.from_numpy(outs[0]), torch.from_numpy(exact_server.predict(requests[0])))
    agree = float((outs[0].argmax(1) == exact_server.predict(requests[0]).argmax(1)).mean())

    # --- images/s at batch 512, preset and exact in turns; p50 at batch 1 ----
    rates = {"preset": [], "exact": []}
    for which in ("preset", "exact", "exact", "preset"):
        rates[which].append(_stream_rate(server if which == "preset" else exact_server, requests[:2], 6))
    p50 = _p50_ms(model, requests[0], dev)

    # --- tower times and the device breakdown at batch 512 -------------------
    r = requests[0]
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=False, dtype=torch.bfloat16)
        ids = torch.from_numpy(r["input_ids"]).to(dev)
        mask = torch.from_numpy(r["attention_mask"]).to(dev)
        fwd = lambda: server.model(img, ids, mask)  # noqa: E731
        towers = {
            "resnet_tower_ms": cuda_ms(lambda: server.model.image_encoder(img), reps=5),
            "bert_tower_int8_kernels_ms": cuda_ms(lambda: server.model.text_encoder(ids, mask), reps=5),
            "bert_tower_int8_composite_ms": _composite_ms(lambda: server.model.text_encoder(ids, mask)),
            "bert_tower_exact_bf16_ms": cuda_ms(lambda: exact.text_encoder(ids, mask), reps=5),
            "forward_ms": cuda_ms(fwd, reps=5),
            "forward_exact_bf16_ms": cuda_ms(lambda: exact(img, ids, mask), reps=5),
        }
        towers["device"] = device_profile(fwd, towers["forward_ms"], reps=2)

    emit({"phase": "preset", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16, "
          "fast_math + quantize=int8 (configs/serving/mibf_ham_serving.yml)",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
          "sync_free": sync_free(server.model, requests[0], dev),
          "logits_vs_int8_composite": {"max_abs": lmax, "mean_abs": lmean},
          "bert_out_vs_int8_composite": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "seq256_bert_out_vs_int8_composite": {"max_abs": long_bert_d[0], "mean_abs": long_bert_d[1]},
          "cls_vs_exact_bf16": {"max_abs": cls_d.max().item(), "mean_abs": cls_d.mean().item(),
                                "max_abs_cls": cls_scale},
          "logits_vs_exact_bf16": {"max_abs": logits_exact_d[0], "mean_abs": logits_exact_d[1],
                                   "argmax_agreement": agree},
          "images_per_s_b512_stream": rates["preset"],
          "images_per_s_b512_stream_exact_bf16": rates["exact"],
          "p50_latency_ms_b1": p50, "towers_b512": towers})
    return launches


def phase_seq512(dev, rng, model, plain) -> dict:
    """The exact bf16 model at seq 512, past attention_block's gate."""
    req = _request(rng, BATCH, SEQ512)
    zero_counts()
    out = ServingModel(model, BATCH, dev).predict(req)
    launches = read_counts()
    check(launches == {**dict.fromkeys(KERNELS, 0), "fused_attention": 12, "ffn_block": 12},
          f"seq-512 launches {launches}, expected 12 of fused_attention and ffn_block, no attention_block")
    check(out.shape == (BATCH, LABELS) and bool(np.isfinite(out).all()), "seq-512 logits")
    bert_d = diff(_bert_out(model, req, dev), _bert_out(plain, req, dev))
    logit_d = diff(torch.from_numpy(out), torch.from_numpy(ServingModel(plain, BATCH, dev).predict(req)))
    for what, (mx, mean) in (("BERT output", bert_d), ("logits", logit_d)):
        check(mx <= SLICE_ATOL and mean < SLICE_MEAN, f"seq-512 {what} vs plain: max {mx} mean {mean}")
    with torch.inference_mode():
        ids = torch.from_numpy(req["input_ids"]).to(dev)
        mask = torch.from_numpy(req["attention_mask"]).to(dev)
        towers = {"bert_tower_ms": cuda_ms(lambda: model.text_encoder(ids, mask), reps=5),
                  "bert_tower_device_ms": kernel_device_ms(lambda: model.text_encoder(ids, mask), reps=3),
                  "bert_tower_plain_ms": cuda_ms(lambda: plain.text_encoder(ids, mask), reps=5)}
    emit({"phase": "seq512", "requests": [BATCH], "launches": launches, "sync_free": sync_free(model, req, dev),
          "bert_out_vs_plain": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "logits_vs_plain": {"max_abs": logit_d[0], "mean_abs": logit_d[1]}, "towers_b32": towers})
    return launches


def phase_flash(dev, rng, model) -> dict:
    """The exact model's weights under attention_impl="flash" at seq 512, through
    ServingModel(batch 32): the forward kernel 12 times a forward and no
    sublayer kernel; against the same weights on the plain flash op, and the
    logits against the exact "auto" model (MIBF reads only the CLS token)."""
    cfg = dataclasses.replace(model.text_encoder.bert.cfg, attention_impl="flash")
    flash = _twin(model, cfg, LABELS, dev)
    server = ServingModel(flash, BATCH, dev)
    requests = [_request(rng, n, SEQ512) for n in (BATCH, BATCH, 5)]
    layers = cfg.num_hidden_layers

    # --- the main path: three requests through predict_stream --------------
    zero_counts()
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = read_counts()
    check(launches == {**dict.fromkeys(KERNELS, 0), "flash_attention": layers * len(requests)},
          f"flash launches {launches}, expected {layers} of flash_attention a forward and no other kernel")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, LABELS) and bool(np.isfinite(out).all()), f"flash logits {out.shape}")

    # --- the same weights on the plain flash op (the same pad-row semantics) --
    bert_k = _bert_out(flash, requests[0], dev)
    with _plain_op(fl, "flash_attention_forward", fl.flash_attention_reference):
        plain_outs = [server.predict(r) for r in requests]
        bert_d = diff(bert_k, _bert_out(flash, requests[0], dev))
    logit_d = [diff(torch.from_numpy(o), torch.from_numpy(p)) for o, p in zip(outs, plain_outs)]
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    for what, (mx, mean) in (("BERT output", bert_d), ("logits", (lmax, lmean))):
        check(mx <= SLICE_ATOL and mean < SLICE_MEAN, f"flash {what} vs plain flash op: max {mx} mean {mean}")
    # --- against the exact model: the CLS rows and the logits -----------------
    exact_server = ServingModel(model, BATCH, dev)
    exact_d = [diff(torch.from_numpy(o), torch.from_numpy(exact_server.predict(r))) for o, r in zip(outs, requests)]
    emax, emean = max(d[0] for d in exact_d), max(d[1] for d in exact_d)
    check(emax <= SLICE_ATOL and emean < SLICE_MEAN, f"flash logits vs exact: max {emax} mean {emean}")
    cls_d = diff(bert_k[:, 0], _bert_out(model, requests[0], dev)[:, 0])

    # --- seq 128 takes the kernel, seq 200 (not a multiple of 128) the plain path
    other = {}
    for seq, want in ((SEQ, layers), (200, 0)):
        req = _request(rng, 8, seq)
        zero_counts()
        out = ServingModel(flash, 8, dev).predict(req)
        other[f"seq{seq}"] = read_counts()
        check(other[f"seq{seq}"] == {**dict.fromkeys(KERNELS, 0), "flash_attention": want},
              f"flash seq-{seq} launches {other[f'seq{seq}']}, expected {want} of flash_attention")
        check(out.shape == (8, LABELS) and bool(np.isfinite(out).all()), f"flash seq-{seq} logits")

    # --- rates, tower times and the device breakdown at batch 32 -------------
    images_per_s = _stream_rate(server, requests[:2], 12)
    p50 = _p50_ms(flash, requests[0], dev)
    r = requests[0]
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=False, dtype=torch.bfloat16)
        ids = torch.from_numpy(r["input_ids"]).to(dev)
        mask = torch.from_numpy(r["attention_mask"]).to(dev)
        fwd = lambda: flash(img, ids, mask)  # noqa: E731
        towers = {"bert_tower_flash_ms": cuda_ms(lambda: flash.text_encoder(ids, mask), reps=5),
                  "bert_tower_flash_device_ms": kernel_device_ms(lambda: flash.text_encoder(ids, mask), reps=3),
                  "bert_tower_exact_ms": cuda_ms(lambda: model.text_encoder(ids, mask), reps=5),
                  "forward_ms": cuda_ms(fwd, reps=5), "forward_exact_ms": cuda_ms(lambda: model(img, ids, mask), reps=5)}
        towers["device"] = device_profile(fwd, towers["forward_ms"], top=8)
    emit({"phase": "flash", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16, attention_impl=flash, seq 512",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
          "sync_free": sync_free(flash, requests[0], dev), "launches_seq128_seq200": other,
          "logits_vs_plain_op": {"max_abs": lmax, "mean_abs": lmean},
          "bert_out_vs_plain_op": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "logits_vs_exact": {"max_abs": emax, "mean_abs": emean},
          "cls_vs_exact": {"max_abs": cls_d[0], "mean_abs": cls_d[1]},
          "images_per_s_b32_stream": images_per_s, "p50_latency_ms_b1": p50, "towers_b32": towers})
    del flash, server, exact_server
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _plain_op(module, name: str, plain):
    """``module.name`` routed to its plain version, on the card (comparison only)."""
    kernel = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def _route_rows_apart(model, request, dev, g) -> None:
    """Draw the MoE gate at random, then take out its component along the
    mean fused feature of ``request``: with random weights the rows' features
    share most of their direction, so a gate drawn as it is (or JAX's zero
    init) sends every row to the same two experts."""
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(request["image"]).to(dev), 224, normalize=True, dtype=torch.bfloat16)
        feats = model.forward_features(img, torch.from_numpy(request["input_ids"]).to(dev),
                                       torch.from_numpy(request["attention_mask"]).to(dev)).float()
    m = feats.mean(dim=0)
    w = torch.randn(model.classifier.moe.w_gate.shape, generator=g, device=dev)
    with torch.no_grad():
        model.classifier.moe.w_gate.copy_(w - m[:, None] * (m @ w)[None, :] / (m @ m))


def phase_baseline(dev, rng, seed: int) -> dict:
    """The baseline family's two served configurations at full width, bf16,
    through ServingModel(batch 64); returns the launches of each main path."""
    result = {}
    runs = (("ham_fusion_ssm_v1", HAM_FUSION_SSM, "selective_scan", 1, ss, ss.selective_scan_reference),
            ("ham_head_moe_v1", HAM_HEAD_MOE, "kan_forward", 2, ks, ks.kan_forward_reference))
    for i, (name, cfg, kernel, per_forward, module, plain) in enumerate(runs):
        g = torch.Generator(device=dev).manual_seed(seed + 10 + i)
        model = init_parameters(MultimodalBaselineModel(cfg, device=dev, dtype=torch.bfloat16), g).eval()
        requests = [_request(rng, n, BASELINE_SEQ) for n in (BASELINE_BATCH, BASELINE_BATCH, 9)]
        if cfg.classifier_type == "moe":
            _route_rows_apart(model, requests[0], dev, g)
        server = ServingModel(model, BASELINE_BATCH, dev)
        layers = cfg.bert.num_hidden_layers

        # --- the main path: three requests through predict_stream, then one of 1 row
        zero_counts()
        outs = list(server.predict_stream(iter(requests), depth=2))
        launches = read_counts()
        want = {**dict.fromkeys(KERNELS, 0), "attention_block": layers * 3, "ffn_block": layers * 3,
                kernel: per_forward * 3}
        check(launches == want, f"{name} launches {launches}, expected {want}")
        for req, out in zip(requests, outs):
            n = req["image"].shape[0]
            check(out.shape == (n, cfg.num_classes) and bool(np.isfinite(out).all()), f"{name} logits {out.shape}")
        one = {k: v[:1] for k, v in requests[2].items()}
        zero_counts()
        one_out = ServingModel(model, 1, dev).predict(one)
        one_launches = read_counts()
        check(one_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers,
                               kernel: per_forward}, f"{name} batch-1 launches {one_launches}")
        check(bool(np.isfinite(one_out).all()), f"{name} batch-1 logits")

        # --- the same weights with the op routed to its plain version ---------
        with _plain_op(module, kernel, plain):
            plain_outs = [server.predict(r) for r in requests]
        logit_d = [diff(torch.from_numpy(o), torch.from_numpy(p)) for o, p in zip(outs, plain_outs)]
        lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
        scale = max(float(np.abs(p).max()) for p in plain_outs)
        bound = BF16_STEPS * scale
        check(lmax <= bound and lmean <= BF16_MEAN * scale,
              f"{name} logits kernel vs plain op: max {lmax} (bound {bound}) mean {lmean}, max |logit| {scale}")

        # --- rates, forward time, device breakdown ---------------------------
        images_per_s = _stream_rate(server, requests[:2], 16)
        p50 = _p50_ms(model, requests[0], dev)
        r = requests[0]
        with torch.inference_mode():
            img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=True, dtype=torch.bfloat16)
            ids = torch.from_numpy(r["input_ids"]).to(dev)
            mask = torch.from_numpy(r["attention_mask"]).to(dev)
            fwd = lambda: server.model(img, ids, mask)  # noqa: E731
            forward_ms = cuda_ms(fwd, reps=10)
            with _plain_op(module, kernel, plain):
                forward_plain_op_ms = cuda_ms(fwd, reps=10)
            device = device_profile(fwd, forward_ms, top=8)
            routes = None
            if cfg.classifier_type == "moe":
                gates, _ = noisy_top_k_gating(server.model.forward_features(img, ids, mask),
                                              server.model.classifier.moe.w_gate, None, cfg.moe_k)
                chosen = ["+".join(map(str, np.flatnonzero(row))) for row in (gates > 0).cpu().numpy()]
                routes = {pair: chosen.count(pair) / len(chosen) for pair in sorted(set(chosen))}
        emit({"phase": "baseline", "config": name, "model": f"MultimodalBaselineModel: {cfg.image_backbone} + "
              f"BERT-base, fusion {cfg.fusion_type}, head {cfg.classifier_type}, hidden {cfg.hidden_dim}, bf16",
              "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
              "sync_free": sync_free(server.model, requests[0], dev), "launches_batch1": one_launches, "logits_vs_plain_op": {"max_abs": lmax, "mean_abs": lmean, "max_abs_bound": bound,
                                                        "max_abs_logit": scale},
              "expert_pair_share_b64": routes, "images_per_s_b64_stream": images_per_s, "p50_latency_ms_b1": p50,
              "forward_ms_b64": forward_ms, "forward_plain_op_ms_b64": forward_plain_op_ms, "device_b64": device})
        result[kernel] = launches
        del model, server
        torch.cuda.empty_cache()
    return result


def _train_batch(rng, n_valid: int) -> dict:
    """A loader-shaped host batch: uint8 canvases, seq-256 tokens, labels and n_valid."""
    b = _request(rng, MIBF_HAM_TRAIN.batch_size, MIBF_HAM_TRAIN.seq_len)
    b["label"] = rng.integers(0, LABELS, MIBF_HAM_TRAIN.batch_size).astype(np.int64)
    b["n_valid"] = np.int32(n_valid)
    return b


def _towers(model) -> dict:
    """Parameter-name prefixes of the towers whose gradients are compared."""
    groups = {"image_encoder": [], "text_encoder": [], "textbased_cross_attention": [],
              "imagbased_cross_attention": [], "heads": []}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        groups[top if top in groups else "heads"].append(p)
    return groups


def _grad_cosines(a, b) -> dict:
    out = {}
    for (name, pa), (_, pb) in zip(_towers(a).items(), _towers(b).items()):
        ga = torch.cat([p.grad.double().flatten() for p in pa])
        gb = torch.cat([p.grad.double().flatten() for p in pb])
        out[name] = (ga @ gb / (ga.norm() * gb.norm() + 1e-30)).item()
    return out


def _forward_flops(model, images, ids, mask) -> float:
    """FLOPs of one training-mode forward, from the shapes: every convolution
    and Linear (2 * outputs * fan-in) plus BERT's attention products (4 B L^2 H
    a layer). The step is counted as three forwards (backward ~ 2x)."""
    total = [0.0]

    def conv(m, i, o):
        total[0] += 2.0 * o.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]

    def lin(m, i, o):
        total[0] += 2.0 * o.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2d) else lin)
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            model.train()
            model(images, ids, mask)
    finally:
        for h in hooks:
            h.remove()
    cfg = model.text_encoder.bert.cfg
    B, L = ids.shape
    return total[0] + 4.0 * B * L * L * cfg.hidden_size * cfg.num_hidden_layers


def _step_parts_ms(trainer, batch, reps: int = 5) -> dict:
    """Median CUDA-event times of one step's parts: augmentation, forward +
    backward, optimizer (H2D staged before the first event)."""
    parts = {"augment_ms": [], "forward_backward_ms": [], "optimizer_ms": [], "step_ms": []}
    for _ in range(reps):
        dev_b = trainer.to_device(batch)
        valid = trainer.valid_mask(batch, dev_b["label"].shape[0])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        images = trainer.augment(dev_b["image"])
        ev[1].record()
        trainer.forward_backward(images, dev_b, valid)
        ev[2].record()
        trainer.optimizer_step()
        ev[3].record()
        ev[3].synchronize()
        parts["augment_ms"].append(ev[0].elapsed_time(ev[1]))
        parts["forward_backward_ms"].append(ev[1].elapsed_time(ev[2]))
        parts["optimizer_ms"].append(ev[2].elapsed_time(ev[3]))
        parts["step_ms"].append(ev[0].elapsed_time(ev[3]))
    return {k: statistics.median(v) for k, v in parts.items()}


def _images_per_s(trainer, batches, steps: int = 8) -> float:
    """Host clock over ``steps`` whole train_steps (H2D, augmentation, forward,
    backward, Adam) after two of warm-up."""
    for b in batches[:2]:
        trainer.train_step(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    return steps * MIBF_HAM_TRAIN.batch_size / (time.perf_counter() - t0)


def _damp_residual_branches(model) -> nn.Module:
    with torch.no_grad():
        for name, m in model.image_encoder.named_modules():
            if name.endswith(".bn3"):
                m.weight.fill_(RESIDUAL_BN_SCALE)
    return model


def phase_train(dev, rng, seed: int) -> dict:
    """MIBF-Net training at full width (MIBF_HAM_TRAIN): Trainer.fit, the
    launches of each path, augmentation kernel vs plain, rates and times, the
    bf16 step against a float32 twin, and the bn_stats A/B."""
    preset = MIBF_HAM_TRAIN
    B = preset.batch_size
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    master = _damp_residual_branches(init_parameters(MIBFNet(preset.num_labels, preset.bert, device=dev), g))
    trainer = Trainer(preset, model=master, device=dev)  # bf16 working module
    train = [_train_batch(rng, n) for n in (B, B, 21)]  # the last batch is short: 11 padded rows
    val = [_train_batch(rng, B), _train_batch(rng, 19)]
    masters = dict(zip((n for n, _ in trainer.model.named_parameters()), trainer.master_parameters()))
    watch = {n: masters[n].detach().clone() for n in ("fc.weight", "image_encoder.conv1.weight",
                                                      "text_encoder.bert.encoder.layer.0.attention.self.query.weight")}
    bn1 = trainer.model.image_encoder.bn1
    rm0 = bn1.running_mean.clone()

    # --- the main path: Trainer.fit, 2 epochs x 3 steps, validation on 2 batches an epoch
    zero_counts()
    history = trainer.fit(train, val, num_epochs=2, steps_per_epoch=3)
    launches = read_counts()
    layers, n_steps, n_val = preset.bert.num_hidden_layers, 6, 4
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3 * n_steps, "attention_block": layers * n_val,
            "ffn_block": layers * n_val}
    check(launches == want, f"fit launches {launches}, expected {want}")
    losses = [x for h in history for x in h["train_losses"]] + [h["val_loss"] for h in history]
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    check(all(not torch.equal(p, masters[n]) for n, p in watch.items()), "parameters unchanged")
    check(bn1.running_var.dtype == torch.float32 and bn1.running_mean.dtype == torch.float32
          and not torch.equal(bn1.running_mean, rm0), "BatchNorm running statistics not updated in float32")
    check(int(bn1.num_batches_tracked) == n_steps, f"num_batches_tracked {int(bn1.num_batches_tracked)}")

    # --- each path alone: a training step launches the three shears and nothing else;
    # --- a validation forward the two sublayer kernels, 12 each
    zero_counts()
    trainer.train_step(train[0])
    step_launches = read_counts()
    check(step_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3}, f"train_step launches {step_launches}")
    zero_counts()
    trainer.validate(val[:1])
    val_launches = read_counts()
    check(val_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers},
          f"validation launches {val_launches}")

    # --- the augmentation: kernel against plain version on the same sampled values
    canv = trainer.to_device(train[1])["image"]
    p = aug.sample_crop_flip_rotate(B, preset.canvas, trainer.generator, vflip=preset.vflip, degrees=preset.degrees)
    x_kernel = trainer.augment(canv, params=p)
    with _plain_op(aug, "shear_sublane", sh.shear_reference):  # rotate_3shear through the plain shear
        x_plain = trainer.augment(canv, params=p)
    aug_d = diff(x_kernel, x_plain)
    check(aug_d[0] == 0.0 and x_kernel.shape == (B, 3, preset.image_size, preset.image_size),
          f"augmentation kernel vs plain: {aug_d}, shape {tuple(x_kernel.shape)}")

    # --- rates and times of the step
    images_per_s = _images_per_s(trainer, train)
    parts = _step_parts_ms(trainer, train[0])
    device = device_profile(lambda: trainer.train_step(train[0]), parts["step_ms"], reps=2, top=15)
    with torch.no_grad():
        dev_b = trainer.to_device(train[0])
        images = trainer.augment(dev_b["image"])
    step_flops = 3.0 * _forward_flops(trainer.model, images, dev_b["input_ids"], dev_b["attention_mask"])
    flop_share = step_flops / (parts["step_ms"] / 1e3) / BF16_OPS

    # --- bn_stats A/B: the same weights and batch, cuDNN BatchNorm against
    # --- MIBFNet(bn_stats_kernel=True) in a trainer of its own
    twin = MIBFNet(preset.num_labels, preset.bert, bn_stats_kernel=True, device=dev)
    twin.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in trainer.model.state_dict().items()})
    trainers = {"cudnn": trainer, "bn_stats": Trainer(preset, model=twin, device=dev)}
    valid = trainer.valid_mask(train[0], B)
    bn_inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, i: bn_inputs.append((tuple(i[0].shape), i[0].dtype)))
             for m in trainer.model.modules() if isinstance(m, BatchNorm2d)]
    zero_counts()
    torch.manual_seed(seed)  # the same dropout masks in both runs
    loss_cudnn, _ = trainer.forward_backward(images, dev_b, valid)
    for h in hooks:
        h.remove()
    check(bns.bn_stats.launches == 0, "bn_stats launched with the switch off")
    accepted = sum(bns.supports((s[0] * s[2] * s[3], s[1]), dt) for s, dt in bn_inputs)
    zero_counts()
    torch.manual_seed(seed)
    loss_kernel, _ = trainers["bn_stats"].forward_backward(images, dev_b, valid)
    ab_launches = read_counts()
    check(ab_launches == {**dict.fromkeys(KERNELS, 0), "bn_stats": accepted},
          f"bn_stats A/B launches {ab_launches}, expected {accepted} of {len(bn_inputs)} BatchNorm inputs")
    rel = abs(loss_kernel.item() - loss_cudnn.item()) / abs(loss_cudnn.item())
    check(rel <= BN_AB_LOSS_REL, f"bn_stats A/B loss {loss_kernel.item()} vs {loss_cudnn.item()}")
    zero_counts()
    trainers["bn_stats"].validate(val[:1])
    check(bns.bn_stats.launches == 0, "bn_stats launched in eval")
    ab_parts = {"cudnn": [], "bn_stats": []}
    for which in ("cudnn", "bn_stats", "bn_stats", "cudnn"):
        ab_parts[which].append(_step_parts_ms(trainers[which], train[0], reps=3))
    ab_ms = {w: [p["step_ms"] for p in v] for w, v in ab_parts.items()}
    ab_device = {}
    for which in trainers:
        fb_ms = statistics.median(p["forward_backward_ms"] for p in ab_parts[which])
        ab_device[which] = device_profile(lambda t=trainers[which]: t.forward_backward(images, dev_b, valid),
                                          fb_ms, reps=1)
    del trainer, trainers, master, twin
    torch.cuda.empty_cache()

    # --- the bf16 step against a float32 twin: same weights, same augmented batch, dropout 0;
    # --- checked with the damped residual branches, reported for the seeded init as it is
    nodrop = dataclasses.replace(preset, bert=dataclasses.replace(preset.bert, hidden_dropout=0.0,
                                                                 attention_dropout=0.0))
    mixed = {}
    for which, damp in (("damped", True), ("seeded_init", False)):
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        m16 = init_parameters(MIBFNet(preset.num_labels, nodrop.bert, device=dev), g)
        t16 = Trainer(nodrop, model=_damp_residual_branches(m16) if damp else m16, device=dev)
        twin = MIBFNet(preset.num_labels, nodrop.bert, device=dev)
        twin.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in t16.model.state_dict().items()})
        t32 = Trainer(dataclasses.replace(nodrop, precision="f32"), model=twin, device=dev)
        dev_b = t32.to_device(train[0])
        valid = t32.valid_mask(train[0], B)
        x32 = t32.augment(dev_b["image"])
        loss32, _ = t32.forward_backward(x32, dev_b, valid)
        loss16, _ = t16.forward_backward(x32.to(torch.bfloat16), dev_b, valid)
        mixed[which] = {"loss_bf16": loss16.item(), "loss_f32": loss32.item(),
                        "loss_rel": abs(loss16.item() - loss32.item()) / abs(loss32.item()),
                        "grad_cosine": _grad_cosines(t16.model, t32.model)}
        del t16, t32, twin, m16
        torch.cuda.empty_cache()
    d = mixed["damped"]
    check(d["loss_rel"] <= MIXED_LOSS_REL, f"bf16 vs float32 loss: {mixed}")
    check(all(c >= MIXED_GRAD_COS for c in d["grad_cosine"].values()), f"bf16 vs float32 gradients: {mixed}")

    emit({"phase": "train", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16 module with float32 "
          f"masters, residual-branch BatchNorm scale {RESIDUAL_BN_SCALE}, MIBF_HAM_TRAIN (configs/mibf/mibf_ham.yml): batch 32, seq 256, canvas 256 -> 224, Adam 2e-5, "
          "cosine, KL_loss, degrees 15",
          "history": history, "launches_fit": launches, "launches_train_step": step_launches,
          "launches_validation_forward": val_launches, "augment_kernel_vs_plain_max_abs": aug_d[0],
          "images_per_s_b32": images_per_s, "step_parts_ms": parts, "device": device,
          "step_tflop": step_flops / 1e12, "flop_share_of_989_tflops": flop_share,
          "bn_stats_ab": {"bn_inputs": len(bn_inputs), "accepted": accepted, "launches": ab_launches["bn_stats"],
                          "loss_cudnn": loss_cudnn.item(), "loss_bn_stats": loss_kernel.item(), "loss_rel": rel,
                          "step_ms": ab_ms, "device_forward_backward": ab_device},
          "bf16_vs_f32": mixed})
    return {"launches": launches, "ab_launches": ab_launches}


def phase_train_flash(dev, rng, seed: int) -> dict:
    """MIBF_HAM_TRAIN with BERT under attention_impl="flash" and attention
    dropout 0: Trainer.fit over 2 steps and a validation batch, the launches
    of a step and of a validation forward, one step against the plain flash
    op, and step ms and the device breakdown in turns against the same preset
    under "auto" (attention dropout 0 as well, the plain training path)."""
    base = MIBF_HAM_TRAIN
    B, layers = base.batch_size, base.bert.num_hidden_layers
    presets = {impl: dataclasses.replace(base, bert=dataclasses.replace(base.bert, attention_impl=impl,
                                                                       attention_dropout=0.0))
               for impl in ("flash", "auto")}
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    master = _damp_residual_branches(init_parameters(MIBFNet(base.num_labels, presets["flash"].bert, device=dev), g))
    twin = MIBFNet(base.num_labels, presets["auto"].bert, device=dev)
    twin.load_state_dict(master.state_dict())
    trainers = {impl: Trainer(presets[impl], model=m, device=dev) for impl, m in (("flash", master), ("auto", twin))}
    trainer = trainers["flash"]
    train = [_train_batch(rng, B), _train_batch(rng, B)]
    val = [_train_batch(rng, B)]

    # --- the main path: Trainer.fit, one epoch of 2 steps and a validation batch
    zero_counts()
    history = trainer.fit(train, val, num_epochs=1, steps_per_epoch=2)
    launches = read_counts()
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 6, "flash_attention": 3 * layers,
            "flash_attention_bwd_dkv": 2 * layers, "flash_attention_bwd_dq": 2 * layers}
    check(launches == want, f"flash fit launches {launches}, expected {want}")
    losses = history[0]["train_losses"] + [history[0]["val_loss"]]
    check(all(np.isfinite(losses)), f"non-finite flash losses {losses}")
    zero_counts()
    trainer.train_step(train[0])
    step_launches = read_counts()
    check(step_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3, "flash_attention": layers,
                            "flash_attention_bwd_dkv": layers, "flash_attention_bwd_dq": layers},
          f"flash train_step launches {step_launches}")
    zero_counts()
    trainer.validate(val)
    val_launches = read_counts()
    check(val_launches == {**dict.fromkeys(KERNELS, 0), "flash_attention": layers},
          f"flash validation launches {val_launches}")

    # --- one step against the plain flash op: same weights, batch, images and dropout masks
    dev_b = trainer.to_device(train[0])
    valid = trainer.valid_mask(train[0], B)
    with torch.no_grad():
        images = trainer.augment(dev_b["image"])
    bert_params = list(trainer.model.text_encoder.parameters())
    step = {}
    for which in ("kernels", "plain"):
        with contextlib.ExitStack() as stack:
            if which == "plain":
                for name, plain in (("flash_attention_forward", fl.flash_attention_reference),
                                    ("flash_attention_bwd_dkv", fl.flash_attention_bwd_dkv_reference),
                                    ("flash_attention_bwd_dq", fl.flash_attention_bwd_dq_reference)):
                    stack.enter_context(_plain_op(fl, name, plain))
            torch.manual_seed(seed)
            loss, _ = trainer.forward_backward(images, dev_b, valid)
        step[which] = (loss.item(), torch.cat([p.grad.double().flatten() for p in bert_params]))
    (loss_k, gk), (loss_p, gp) = step["kernels"], step["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = (gk @ gp / (gk.norm() * gp.norm() + 1e-30)).item()
    check(rel <= FLASH_LOSS_REL and cos >= FLASH_GRAD_COS,
          f"flash step vs plain flash op: loss {loss_k} vs {loss_p}, BERT gradient cosine {cos}")
    del step, gk, gp

    # --- step ms in turns against "auto", and each step's device breakdown
    parts = {"auto": [], "flash": []}
    for which in ("auto", "flash", "flash", "auto"):
        parts[which].append(_step_parts_ms(trainers[which], train[0], reps=3))
    device = {w: device_profile(lambda t=trainers[w]: t.train_step(train[0]),
                                statistics.median(p["step_ms"] for p in parts[w]), reps=2, top=12)
              for w in trainers}
    emit({"phase": "train_flash", "model": "MIBFNet(num_labels=7), MIBF_HAM_TRAIN (batch 32, seq 256) with BERT "
          "attention_impl=flash, attention_dropout 0; bf16 module, float32 masters, residual-branch BatchNorm "
          f"scale {RESIDUAL_BN_SCALE}", "history": history, "launches_fit": launches,
          "launches_train_step": step_launches, "launches_validation_forward": val_launches,
          "step_vs_plain_op": {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel": rel,
                               "bert_grad_cosine": cos},
          "step_parts_ms": parts, "device": device})
    del trainers, trainer, master, twin
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    rng = np.random.default_rng(seed)

    dev, smi = phase_device()
    phase_build()
    summary = phase_kernels(dev, rng)
    summary["attention_ablate"], ablate_launches = phase_ablate(dev, rng)
    slice_launches, model, plain = phase_slice(dev, rng, seed)
    seq512_launches = phase_seq512(dev, rng, model, plain)
    flash_launches = phase_flash(dev, rng, model)
    del model, plain
    torch.cuda.empty_cache()
    preset_launches = phase_preset(dev, rng, seed)
    torch.cuda.empty_cache()
    baseline = phase_baseline(dev, rng, seed)
    train = phase_train(dev, rng, seed)
    train_flash = phase_train_flash(dev, rng, seed)
    main_path = {"attention_block": slice_launches, "ffn_block": slice_launches,
                 "fused_attention": seq512_launches, "int8_ffn_block": preset_launches,
                 "int8_attention_block": preset_launches, "shear_sublane": train["launches"],
                 "bn_stats": train["ab_launches"], **baseline, "flash_attention": flash_launches,
                 "flash_attention_bwd_dkv": train_flash, "flash_attention_bwd_dq": train_flash,
                 "attention_ablate": {"attention_ablate": ablate_launches}}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_path[name][name], "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "device_ms": summary[name]["device_ms"], "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"], "bound_by": summary[name]["bound_by"],
         "library_ms": summary[name]["library_ms"], "library_device_ms": summary[name]["library_device_ms"]}
        for name, (_, src, rep) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
