"""torch.profiler's kernel records of a run on the card, with a capture
window that holds all of it.

On an H100 the profiler now and then loses the last kernel records of a
short run whose window closes as soon as the device goes idle: a trace of
20 launches comes back with only its first few. ``kernel_events`` keeps
the device idle for ``PAD_S`` of host time at each end of the window, and
traces the run again, up to ``TRIES`` times, when its records fail the
caller's check of completeness.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

PAD_S = 0.02
TRIES = 3


def whole_calls(reps: int) -> Callable[[list], bool]:
    """The check for ``reps`` calls of a function that launches the same
    kernels every call: each kernel's record count is a multiple of ``reps``."""
    def check(events: list) -> bool:
        counts: dict[str, int] = {}
        for e in events:
            counts[e.name] = counts.get(e.name, 0) + 1
        return all(n % reps == 0 for n in counts.values())

    return check


def kernel_events(fn, reps: int = 1, complete: Callable[[list], bool] | None = None) -> list:
    """The CUDA kernel records (``FunctionEvent``s, user annotations left
    out) of ``reps`` calls of ``fn`` after one warm-up call, in the order
    they started on the device. ``complete(events)`` says whether a trace
    holds the whole run; a trace that fails it is taken again, and after
    ``TRIES`` failures this raises. ``None`` takes the first trace."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        # a user annotation (torch.optim's "Optimizer.step#Adam.step") spans kernels counted on their own
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        if complete is None or complete(events):
            return events
    raise RuntimeError(f"the profiler lost kernel records in each of {TRIES} traces; the last held "
                       f"{len(events)}")


def by_kernel(events: list, reps: int) -> list[tuple[str, float, float]]:
    """(name, device ms a call, launches a call) of each kernel in ``events``,
    in the order of first start."""
    out: dict[str, list[float]] = {}
    for e in events:
        row = out.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3 / reps
        row[1] += 1
    return [(name, ms, n / reps) for name, (ms, n) in out.items()]
