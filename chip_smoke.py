#!/usr/bin/env python3
"""Drive the PyTorch port's MIBF-Net serving paths once on an NVIDIA GPU.

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
              times of kernel and plain version, the bound (the larger of
              bytes / 3.35 TB/s and operations / peak rate, from this run's
              shapes), and for fused_attention the time of
              scaled_dot_product_attention on the same inputs (timing only)
  4. slice    full-width MIBF-Net (ResNet50 + BERT-base, 7 labels), bf16,
              exact-parity, seeded random weights, through ServingModel(batch
              32): 3 requests (32, 32, 5 rows, seq 128) via predict_stream with
              attention_block and ffn_block launched 12 times a forward; the
              plain path (attention_impl="plain") on the same weights within
              atol 0.15 and mean |d| < 0.01 (tests/test_fused_attention.py:
              97-105); one request at seq 256; images/s at batch 32, p50
              latency at batch 1, tower times and the device breakdown
  5. preset   the int8 serving preset (configs/serving/mibf_ham_serving.yml:
              fast_math, quantize int8, batch 512) at full width, through
              ServingModel(batch 512): 3 requests (512, 512, 77 rows, seq 128)
              via predict_stream with int8_attention_block and int8_ffn_block
              launched 12 times a forward and no bf16 sublayer kernel; one
              request of 512 rows at seq 256 (the preset's tokenizer length),
              12 launches of each; on the same weights, the int8 composite
              (attention_impl="plain") within 0.25 / 0.03 on logits and BERT
              output (INT8_ATOL says why), and the exact bf16 path with CLS drift mean |d| < 0.062 *
              max |CLS| (twice docs/PARITY.md:21's TPU drift); images/s at batch
              512 of the preset and of the exact bf16 model in turns, p50
              latency at batch 1, tower times and the device breakdown
  6. seq512   the exact bf16 MIBF-Net, one request of 32 rows at seq 512:
              fused_attention and ffn_block launched 12 times, attention_block
              none; BERT output and logits within 0.15 / 0.01 of the plain path
Then a JSON line of the kernels, the nvidia-smi line, and the result line.
Each path sets every launch count to 0 just before it runs and reads them
just after. Any failure raises: the exit code is not 0 and no result line is
printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mdhs_tpu_torch import resolve_device
from mdhs_tpu_torch.models.bert import BertConfig
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet
from mdhs_tpu_torch.ops import _build
from mdhs_tpu_torch.ops import attention_block as ab
from mdhs_tpu_torch.ops import ffn_block as fb
from mdhs_tpu_torch.ops import fused_attention as fa
from mdhs_tpu_torch.ops import quant_kernel as qk
from mdhs_tpu_torch.ops.preprocess import eval_pipeline
from mdhs_tpu_torch.ops.quant import quantize_weight
from mdhs_tpu_torch.serving import MIBF_HAM_SERVING, ServingModel

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
# H100 SXM datasheet peaks at 700 W: bytes/s of HBM, dense ops/s
HBM_BPS, BF16_OPS, INT8_OPS = 3.35e12, 989e12, 1979e12

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
    "gemm_s8_residual_ln_kernel": ("gemm_s8_residual_ln_kernel",),
    "gemm_s8_kernel": ("gemm_s8_kernel",),
    "row_quantize_kernel": ("row_quantize_kernel",),
    "gemm_residual_ln_kernel": ("gemm_residual_ln_kernel",),
    "gemm_bias_kernel": ("gemm_bias_kernel",),
    "fused_attention_kernel": ("fused_attention_kernel",),
    "attention_kernel": ("attention_kernel",),
    "cudnn_conv": ("fprop", "conv"),
    "batch_norm": ("batch_norm",),
    "cublas_gemm": ("nvjet", "gemm", "cublas"),
}


def device_profile(fn, forward_ms: float, reps: int = 3) -> dict:
    """Device time per forward by kernel family (torch.profiler, CUDA events
    only), and its share of the unprofiled CUDA-event time of the forward."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = dict.fromkeys([*_FAMILIES, "other"], 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        fam = next((f for f, frags in _FAMILIES.items() if any(x in name for x in frags)), "other")
        by[fam] += e.self_device_time_total / 1e3 / reps
    busy = sum(by.values())
    return {"kernel_ms": busy, "busy_share": busy / forward_ms, "by_family_ms": by}


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


def phase_build() -> None:
    path, seconds = _build.build()
    _build.load_library()
    emit({"phase": "build", "library": str(path.relative_to(_build.BUILD_DIR.parent.parent)),
          "seconds": seconds})


def _rand(rng, shape, scale, dev):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.bfloat16, device=dev)


def _rand_f32(rng, shape, scale, dev, offset=0.0):
    return torch.tensor(offset + rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)


def _key_bias(B, L, n_pad, dev):
    mask = np.ones((B, L), np.float32)
    mask[:, L - n_pad:] = 0.0  # the last n_pad keys of each row are padding
    return torch.tensor((1.0 - mask) * -1e9, device=dev)


def _kernel_cases(dev, rng):
    """(name, shape, plain, args, main path?, (bound_ms, bound_by), library call or None, int8?)."""
    cases = []
    for B, L in ((8, 128), (8, 256), (BATCH, SEQ)):
        args = (_rand(rng, (B, L, HD), 1.0, dev), _rand(rng, (3 * HD, HD), 0.03, dev),
                _rand(rng, (3 * HD,), 0.01, dev), _rand(rng, (HD, HD), 0.03, dev), _rand(rng, (HD,), 0.01, dev),
                (1.0 + _rand(rng, (HD,), 0.1, dev)).contiguous(), _rand(rng, (HD,), 0.1, dev),
                _key_bias(B, L, 28, dev), HEADS, 0.125, 1e-12)
        cases.append(("attention_block", f"B={B},L={L}", ab.attention_block_reference, args,
                      (B, L) == (BATCH, SEQ), bound_attention_block(B, L), None, False))
    for N in (128, BATCH * SEQ):
        for act in ("erf", "tanh"):
            args = (_rand(rng, (N, HD), 1.0, dev), _rand(rng, (DI, HD), 0.03, dev),
                    _rand(rng, (DI,), 0.01, dev), _rand(rng, (HD, DI), 0.03, dev),
                    _rand(rng, (HD,), 0.01, dev), (1.0 + _rand(rng, (HD,), 0.1, dev)).contiguous(),
                    _rand(rng, (HD,), 0.1, dev), 1e-12, act)
            cases.append(("ffn_block", f"N={N},act={act}", fb.ffn_block_reference, args,
                          (N, act) == (BATCH * SEQ, "erf"), bound_ffn_block(N), None, False))
    P = MIBF_HAM_SERVING.batch_size
    for N in (128, P * SEQ):
        for act in ("erf", "tanh"):  # the preset's fast_math takes tanh
            w1, s1 = quantize_weight(_rand(rng, (DI, HD), 0.03, dev))
            w2, s2 = quantize_weight(_rand(rng, (HD, DI), 0.03, dev))
            args = (_rand(rng, (N, HD), 1.0, dev), w1, s1, _rand_f32(rng, (DI,), 0.01, dev), w2, s2,
                    _rand_f32(rng, (HD,), 0.01, dev), _rand_f32(rng, (HD,), 0.1, dev, 1.0),
                    _rand_f32(rng, (HD,), 0.1, dev), 1e-12, act)
            cases.append(("int8_ffn_block", f"N={N},act={act}", qk.int8_ffn_block_reference, args,
                          (N, act) == (P * SEQ, "tanh"), bound_int8_ffn_block(N), None, True))
    for B, L in ((8, 128), (8, LONG_SEQ), (P, SEQ)):
        wqkv, sqkv = quantize_weight(_rand(rng, (3 * HD, HD), 0.03, dev))
        wo, so = quantize_weight(_rand(rng, (HD, HD), 0.03, dev))
        args = (_rand(rng, (B, L, HD), 1.0, dev), wqkv, sqkv, _rand_f32(rng, (3 * HD,), 0.01, dev), wo, so,
                _rand_f32(rng, (HD,), 0.01, dev), _rand_f32(rng, (HD,), 0.1, dev, 1.0),
                _rand_f32(rng, (HD,), 0.1, dev), _key_bias(B, L, 28, dev), HEADS, 0.125, 1e-12)
        cases.append(("int8_attention_block", f"B={B},L={L}", qk.int8_attention_block_reference, args,
                      (B, L) == (P, SEQ), bound_int8_attention_block(B, L), None, True))
    for B, L in ((8, 384), (8, 500), (8, SEQ512), (BATCH, SEQ512)):
        q, k, v = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(3))
        bias = _key_bias(B, L, L // 5, dev)
        args = (q, k, v, bias, HEADS, 0.125)
        heads = [t.view(B, L, HEADS, HD // HEADS).transpose(1, 2) for t in (q, k, v)]
        keep = (bias == 0)[:, None, None, :]
        library = lambda h=heads, m=keep: F.scaled_dot_product_attention(*h, attn_mask=m, scale=0.125)  # noqa: E731
        cases.append(("fused_attention", f"B={B},L={L}", fa.attention_reference, args,
                      (B, L) == (BATCH, SEQ512), bound_fused_attention(B, L), library, False))
    return cases


def phase_kernels(dev, rng) -> dict:
    """Each kernel against its plain version; returns per-kernel summaries."""
    summary = {}
    for name, shape, plain, args, main_path, (bound_ms, bound_by), library, int8 in _kernel_cases(dev, rng):
        kernel = KERNELS[name][0]
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        mx, mean = diff(out, ref)
        check(bool(torch.isfinite(out.float()).all()), f"{name} {shape}: non-finite output")
        max_bound = INT8_FRAC * ref.float().abs().max().item() if int8 else MAX_ABS
        check(mx <= max_bound and mean < MEAN_ABS,
              f"{name} {shape}: max|d|={mx} mean|d|={mean} beyond {max_bound}/{MEAN_ABS}")
        ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
        library_ms = cuda_ms(library) if library is not None else None
        emit({"phase": "kernels", "kernel": name, "shape": shape, "max_abs_err": mx, "mean_abs_err": mean,
              "max_abs_bound": max_bound, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms})
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], mx)
        if main_path:
            s.update(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)
        del out, ref
    torch.cuda.empty_cache()
    return summary


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
    plain = _twin(model, dataclasses.replace(cfg, attention_impl="plain"), LABELS, dev)
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
          "logits_vs_plain": {"max_abs": lmax, "mean_abs": lmean},
          "bert_out_vs_plain": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "seq256_bert_out_vs_plain": {"max_abs": long_bert_d[0], "mean_abs": long_bert_d[1]},
          "images_per_s_b32_stream": images_per_s, "p50_latency_ms_b1": p50, "towers": towers})
    return launches, model, plain


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

    # --- the same weights: the int8 composite, and the exact bf16 path -------
    composite = _twin(model, dataclasses.replace(cfg, attention_impl="plain"), preset.num_labels, dev)
    comp_server = ServingModel(composite, P, dev)
    logit_d = [diff(torch.from_numpy(o), torch.from_numpy(comp_server.predict(r))) for o, r in zip(outs, requests)]
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    bert_q = _bert_out(server.model, requests[0], dev)
    bert_d = diff(bert_q, _bert_out(composite, requests[0], dev))
    long_bert_d = diff(_bert_out(server.model, long_req, dev), _bert_out(composite, long_req, dev))
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
            "bert_tower_int8_composite_ms": cuda_ms(lambda: composite.text_encoder(ids, mask), reps=5),
            "bert_tower_exact_bf16_ms": cuda_ms(lambda: exact.text_encoder(ids, mask), reps=5),
            "forward_ms": cuda_ms(fwd, reps=5),
            "forward_exact_bf16_ms": cuda_ms(lambda: exact(img, ids, mask), reps=5),
        }
        towers["device"] = device_profile(fwd, towers["forward_ms"], reps=2)

    emit({"phase": "preset", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16, "
          "fast_math + quantize=int8 (configs/serving/mibf_ham_serving.yml)",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
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
                  "bert_tower_plain_ms": cuda_ms(lambda: plain.text_encoder(ids, mask), reps=5)}
    emit({"phase": "seq512", "requests": [BATCH], "launches": launches,
          "bert_out_vs_plain": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "logits_vs_plain": {"max_abs": logit_d[0], "mean_abs": logit_d[1]}, "towers_b32": towers})
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    rng = np.random.default_rng(seed)

    dev, smi = phase_device()
    phase_build()
    summary = phase_kernels(dev, rng)
    slice_launches, model, plain = phase_slice(dev, rng, seed)
    seq512_launches = phase_seq512(dev, rng, model, plain)
    del model, plain
    torch.cuda.empty_cache()
    preset_launches = phase_preset(dev, rng, seed)
    main_path = {"attention_block": slice_launches, "ffn_block": slice_launches,
                 "fused_attention": seq512_launches, "int8_ffn_block": preset_launches,
                 "int8_attention_block": preset_launches}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_path[name][name], "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"], "bound_by": summary[name]["bound_by"],
         "library_ms": summary[name]["library_ms"]}
        for name, (_, src, rep) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
