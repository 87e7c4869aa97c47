#!/usr/bin/env python3
"""Drive the PyTorch port's MIBF-Net serving path once on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:
  1. device   require CUDA; the card's name and power limit (nvidia-smi)
  2. build    compile mdhs_tpu_torch/csrc/*.cu with nvcc for sm_90a
  3. kernels  each CUDA kernel against its plain PyTorch version in bf16, at
              the main path's shapes; max |d| <= 6e-2 and mean |d| < 5e-3 (the
              JAX kernels' own bounds, tests/test_fused_attention.py:126-127);
              median CUDA-event times of kernel and plain version
  4. slice    full-width MIBF-Net (ResNet50 + BERT-base, 7 labels), bf16,
              seeded random weights, served through ServingModel(batch_size=32):
              3 requests (32, 32, 5 rows, seq 128) via predict_stream, with each
              kernel launched exactly 12 times a forward; the same weights on
              the plain path (attention_impl="plain") agree within atol 0.15
              and mean |d| < 0.01 (tests/test_fused_attention.py:97-105); one
              request at seq 256; images/sec at batch 32 and p50 latency at
              batch 1, with the ResNet and BERT tower times.
Then a JSON line of the kernels, the nvidia-smi line, and the result line.
Any failure raises: the exit code is not 0 and no result line is printed.
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

from mdhs_tpu_torch import resolve_device
from mdhs_tpu_torch.models.bert import BertConfig
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet
from mdhs_tpu_torch.ops import _build
from mdhs_tpu_torch.ops import attention_block as ab
from mdhs_tpu_torch.ops import ffn_block as fb
from mdhs_tpu_torch.ops.preprocess import eval_pipeline
from mdhs_tpu_torch.serving import ServingModel

MAX_ABS, MEAN_ABS = 6e-2, 5e-3           # kernel vs plain version, bf16
SLICE_ATOL, SLICE_MEAN = 0.15, 0.01      # fused vs plain model path, bf16
BATCH, SEQ, LONG_SEQ, CANVAS, LABELS = 32, 128, 256, 256, 7
VOCAB = 30522


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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
# convolutions are "fprop" kernels, so they are tested before cuBLAS's GEMMs)
_FAMILIES = {
    "gemm_residual_ln_kernel": ("gemm_residual_ln_kernel",),
    "gemm_bias_kernel": ("gemm_bias_kernel",),
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


def phase_kernels(dev, rng) -> dict:
    """Each kernel against its plain version; returns per-kernel summaries."""
    summary = {}
    HD, heads, Di = 768, 12, 3072
    cases = []
    for B, L in ((8, 128), (8, 256), (BATCH, SEQ)):
        x = _rand(rng, (B, L, HD), 1.0, dev)
        mask = np.ones((B, L), np.float32)
        mask[:, L - 28:] = 0.0  # the last 28 keys of each row are padding
        args = (x, _rand(rng, (3 * HD, HD), 0.03, dev), _rand(rng, (3 * HD,), 0.01, dev),
                _rand(rng, (HD, HD), 0.03, dev), _rand(rng, (HD,), 0.01, dev),
                (1.0 + _rand(rng, (HD,), 0.1, dev)).contiguous(), _rand(rng, (HD,), 0.1, dev),
                torch.tensor((1.0 - mask) * -1e9, device=dev), heads, 0.125, 1e-12)
        cases.append(("attention_block", f"B={B},L={L}", ab.attention_block, ab.attention_block_reference,
                      args, (B, L) == (BATCH, SEQ)))
    for N in (128, BATCH * SEQ):
        for act in ("erf", "tanh"):
            args = (_rand(rng, (N, HD), 1.0, dev), _rand(rng, (Di, HD), 0.03, dev),
                    _rand(rng, (Di,), 0.01, dev), _rand(rng, (HD, Di), 0.03, dev),
                    _rand(rng, (HD,), 0.01, dev), (1.0 + _rand(rng, (HD,), 0.1, dev)).contiguous(),
                    _rand(rng, (HD,), 0.1, dev), 1e-12, act)
            cases.append(("ffn_block", f"N={N},act={act}", fb.ffn_block, fb.ffn_block_reference,
                          args, (N, act) == (BATCH * SEQ, "erf")))
    for name, shape, kernel, plain, args, main_path in cases:
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        mx, mean = diff(out, ref)
        check(bool(torch.isfinite(out.float()).all()), f"{name} {shape}: non-finite output")
        check(mx <= MAX_ABS and mean < MEAN_ABS,
              f"{name} {shape}: max|d|={mx} mean|d|={mean} beyond {MAX_ABS}/{MEAN_ABS}")
        ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
        emit({"phase": "kernels", "kernel": name, "shape": shape, "max_abs_err": mx,
              "mean_abs_err": mean, "ms": ms, "plain_ms": plain_ms})
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], mx)
        if main_path:
            s.update(shape=shape, ms=ms, plain_ms=plain_ms)
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


def phase_slice(dev, rng, seed: int) -> dict:
    cfg = BertConfig()  # BERT-base: 12 layers, 768 wide, 12 heads, 3072 inner, vocab 30522
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_parameters(MIBFNet(LABELS, cfg, device=dev, dtype=torch.bfloat16), g)
    server = ServingModel(model, BATCH, dev)
    requests = [_request(rng, n, SEQ) for n in (BATCH, BATCH, 5)]

    # --- the main path: three requests through predict_stream --------------
    ab.attention_block.launches = 0
    fb.ffn_block.launches = 0
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = {"attention_block": ab.attention_block.launches, "ffn_block": fb.ffn_block.launches}
    expect = cfg.num_hidden_layers * len(requests)
    check(launches == {"attention_block": expect, "ffn_block": expect},
          f"kernel launches {launches}, expected {expect} each (12 per forward)")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, LABELS), f"logits shape {out.shape}, expected {(n, LABELS)}")
        check(bool(np.isfinite(out).all()), "non-finite logits")

    # --- the same weights on the plain path --------------------------------
    plain = MIBFNet(LABELS, dataclasses.replace(cfg, attention_impl="plain"), device=dev,
                    dtype=torch.bfloat16)
    plain.load_state_dict(model.state_dict())
    plain_server = ServingModel(plain, BATCH, dev)
    logit_d = [diff(torch.from_numpy(o), torch.from_numpy(plain_server.predict(r)))
               for o, r in zip(outs, requests)]
    bert_d = diff(_bert_out(server.model, requests[0], dev), _bert_out(plain, requests[0], dev))
    check(bert_d[0] <= SLICE_ATOL and bert_d[1] < SLICE_MEAN, f"BERT output fused vs plain: {bert_d}")
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    check(lmax <= SLICE_ATOL and lmean < SLICE_MEAN, f"logits fused vs plain: max {lmax} mean {lmean}")

    # --- one request at seq 256 (configs/mibf/mibf_ham.yml) -----------------
    long_req = _request(rng, 8, LONG_SEQ)
    n_ab, n_fb = ab.attention_block.launches, fb.ffn_block.launches
    long_out = ServingModel(model, 8, dev).predict(long_req)
    check(ab.attention_block.launches - n_ab == 12 and fb.ffn_block.launches - n_fb == 12,
          "seq-256 forward did not launch each kernel 12 times")
    check(long_out.shape == (8, LABELS) and bool(np.isfinite(long_out).all()), "seq-256 logits")
    long_bert_d = diff(_bert_out(server.model, long_req, dev), _bert_out(plain, long_req, dev))
    check(long_bert_d[0] <= SLICE_ATOL and long_bert_d[1] < SLICE_MEAN,
          f"seq-256 BERT output fused vs plain: {long_bert_d}")

    # --- end-to-end rates, host clock around synchronised work ---------------
    stream = [requests[i % 2] for i in range(24)]
    list(server.predict_stream(iter(stream[:4]), depth=2))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in server.predict_stream(iter(stream), depth=2):
        pass
    images_per_s = len(stream) * BATCH / (time.perf_counter() - t0)

    one = ServingModel(model, 1, dev)
    single = [{k: v[i:i + 1] for k, v in requests[0].items()} for i in range(8)]
    for r in single[:3]:
        one.predict(r)
    lat = []
    for i in range(40):
        t0 = time.perf_counter()
        one.predict(single[i % len(single)])
        lat.append((time.perf_counter() - t0) * 1e3)

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
          "images_per_s_b32_stream": images_per_s, "p50_latency_ms_b1": statistics.median(lat),
          "towers": towers})
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    rng = np.random.default_rng(seed)

    dev, smi = phase_device()
    phase_build()
    summary = phase_kernels(dev, rng)
    launches = phase_slice(dev, rng, seed)
    sources = {"attention_block": ("mdhs_tpu_torch/csrc/attention_block.cu", "mdhs_tpu/ops/attention_block.py:110"),
               "ffn_block": ("mdhs_tpu_torch/csrc/ffn_block.cu", "mdhs_tpu/ops/ffn_block.py:80")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "max_abs_err": summary[name]["max_abs_err"], "ms": summary[name]["ms"],
         "plain_ms": summary[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
