"""Where does the fused attention core's time go? Each mode of
``ops/attention_ablate.py`` removes one stage of the Hopper mainloop:

  full     the production core (fused_attention's kernel)
  nomax    softmax without the max subtraction
  nosmax   no softmax at all (probs = scores cast)
  nopv     no PV product (write a slice of probs)
  aligned  every head reads head 0's columns (one head's HBM/L2 traffic, read
           twelve times, against twelve heads')

The numerics are wrong on purpose: timing only. Counterpart of
``benchmarks/attention_ablate.py``, at its shape (B 256, L 128, 12 heads of
64, bf16, zero bias) and with its chain: ``K_STEPS`` calls of
``op(q + t * 1e-3, k, v, bias)``, each output summed into a float32 scalar.
On the card the chain is captured once as a CUDA graph and replayed, as the
JAX chain is one jitted program.

    python -m mdhs_tpu_torch.diagnostics.attention_ablate [--device cuda|cpu] [--seed 0]

prints the JAX script's ``{mode}: {ms} ms/op`` lines (the chain's time over
``K_STEPS``: CUDA events on the card, the host clock on the CPU) and one JSON
line a mode, which adds the profiler's device time of the kernel a call and
the chain's device time a step split into the kernel and the elementwise
passes and sums around it (about 150 MB a step at the full shape).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.attention_ablate import MODES, attention_ablate

B, L, H, D = 256, 128, 12, 64
HD = H * D
K_STEPS = 20
SCALE = float(D) ** -0.5

_KERNEL = "attention_ablate_kernel"  # csrc/attention_ablate.cu


def _offsets(dtype: torch.dtype, device: torch.device, steps: int) -> torch.Tensor:
    """t * 1e-3 for t = 0 .. steps - 1 in the input type, rounded once from
    the exact product of t and 1e-3 in that type, as JAX computes
    ``t.astype(q.dtype) * 1e-3``. Made without a host-to-device copy."""
    return torch.arange(steps, device=device).to(dtype) * torch.full((), 1e-3, dtype=dtype, device=device)


def _steps(mode: str, heads: int, scale: float, steps: int):
    def run(q, k, v, bias):
        offsets = _offsets(q.dtype, q.device, steps)
        c = torch.zeros((), dtype=torch.float32, device=q.device)
        for t in range(steps):
            c = c + attention_ablate(q + offsets[t], k, v, bias, heads, scale, mode).sum(dtype=torch.float32)
        return c

    return run


class Chain:
    """``chain(q, k, v, bias)`` -> the float32 sum over ``steps`` calls of
    one mode. On a CUDA device the calls are captured as one CUDA graph at
    the first call (after one eager warm-up on a side stream, which builds
    and loads the kernels) and replayed; a later call must bring the same
    tensors. On the CPU the calls run eagerly."""

    def __init__(self, mode: str, device, shape: tuple[int, int, int, int]):
        self.mode, self.device, self.steps = mode, resolve_device(device), K_STEPS
        self.B, self.L, self.heads, self.head_dim = shape
        self.eager = _steps(mode, self.heads, float(self.head_dim) ** -0.5, self.steps)
        self._graph = self._out = self._inputs = None

    def __call__(self, q, k, v, bias) -> torch.Tensor:
        want = (self.B, self.L, self.heads * self.head_dim)
        for t, name, shape in ((q, "q", want), (k, "k", want), (v, "v", want), (bias, "bias", want[:2])):
            if tuple(t.shape) != shape or t.device != self.device:
                raise ValueError(f"chain: {name} is {tuple(t.shape)} on {t.device}, expected {shape} on {self.device}")
        if self.device.type == "cpu":
            return self.eager(q, k, v, bias)
        if self._graph is None:
            self._capture(q, k, v, bias)
        elif any(a is not b for a, b in zip((q, k, v, bias), self._inputs)):
            raise ValueError("chain: its CUDA graph was captured on other tensors; build a chain for these")
        self._graph.replay()
        return self._out.clone()

    def _capture(self, *args) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.eager(*args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.eager(*args)
        self._graph, self._out, self._inputs = graph, out, args


def build(mode: str, device, B: int = B, L: int = L, H: int = H, D: int = D) -> Chain:
    """The chain of ``K_STEPS`` calls of one mode at (B, L, H heads of D)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}, expected one of {MODES}")
    return Chain(mode, device, (B, L, H, D))


def timeit(chain: Chain, *args, n: int = 5) -> float:
    """ms per call of the kernel: one warm call of the chain, then the median
    of ``n`` calls over its steps (CUDA events on the card, host clock on the CPU)."""
    chain(*args)
    cuda = chain.device.type == "cuda"
    times = []
    for _ in range(n):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            chain(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            chain(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times) / chain.steps


def device_split(chain: Chain, *args) -> dict:
    """Device time of one eager run of the chain by torch.profiler, a step:
    the kernel's and the rest's (the q + t passes, the sums, the scalar adds),
    and the kernel's own time a call. The kernels are those the graph replays."""
    chain.eager(*args)
    torch.cuda.synchronize(chain.device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chain.eager(*args)
        torch.cuda.synchronize(chain.device)
    kernel_us = other_us = calls = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        if _KERNEL in e.key:
            kernel_us, calls = kernel_us + e.self_device_time_total, calls + e.count
        else:
            other_us += e.self_device_time_total
    if calls != chain.steps:
        raise RuntimeError(f"profiler saw {calls} launches of {_KERNEL}, expected {chain.steps}")
    return {"kernel_device_ms": kernel_us / 1e3 / calls,
            "chain_device_ms_per_step": {"kernel": kernel_us / 1e3 / chain.steps,
                                         "elementwise": other_us / 1e3 / chain.steps}}


def run(q, k, v, bias, heads: int) -> list[dict]:
    """Each mode's chain on these inputs: ms per call (``timeit``), the
    chain's value and, on the card, the device split and the kernel's share
    of the chain's time."""
    Bq, Lq, hidden = q.shape
    results = []
    for mode in MODES:
        chain = build(mode, q.device, Bq, Lq, heads, hidden // heads)
        ms = timeit(chain, q, k, v, bias)
        row = {"mode": mode, "ms_per_op": ms, "chain_value": chain(q, k, v, bias).item(), "steps": chain.steps}
        if q.device.type == "cuda":
            split = device_split(chain, q, k, v, bias)
            row.update(split, kernel_share=split["kernel_device_ms"] / ms)
        results.append(row)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    header = {"device": str(dev), "B": B, "L": L, "H": H, "D": D, "k_steps": K_STEPS}
    if dev.type == "cuda":
        header.update(name=torch.cuda.get_device_name(dev), nvidia_smi=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[dev.index])
    print(json.dumps(header), flush=True)
    rng = np.random.default_rng(args.seed)
    q, k, v = (torch.tensor(rng.standard_normal((B, L, HD)), dtype=torch.bfloat16, device=dev) for _ in range(3))
    bias = torch.zeros((B, L), dtype=torch.float32, device=dev)
    for row in run(q, k, v, bias, H):
        print(f"{row['mode']:8s}: {row['ms_per_op']:.3f} ms/op", flush=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
