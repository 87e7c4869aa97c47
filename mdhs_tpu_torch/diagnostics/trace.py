"""torch.profiler's kernel records of a run on the card, with a capture
window that holds all of it.

On an H100 the profiler now and then loses the last kernel records of a
short run whose window closes as soon as the device goes idle: a trace of
20 launches comes back with only its first few. ``kernel_events`` keeps
the device idle for ``PAD_S`` of host time at each end of the window, and
traces the run again, up to ``TRIES`` times, when its records fail the
caller's check of completeness. A trace can also fail ``whole_trace``'s
check by the same count every time: two training steps of MIBF-Net (about
6,054 records) held 6,053 in each of three tries, in one run of many; a
kernel launched on some calls only, which the census taken before counted
as launched on every call, would do that, so ``whole_trace`` then takes the
census again.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

PAD_S = 0.02
TRIES = 3


def whole_calls(reps: int, irregular=()) -> Callable[[list], bool]:
    """The check for ``reps`` calls of a function that launches the same
    kernels every call: each kernel's record count is a multiple of ``reps``.
    Kernels named in ``irregular`` (a census found their count varying from
    call to call) are left out of it."""
    def check(events: list) -> bool:
        return all(n % reps == 0 for name, n in counts(events).items() if name not in irregular)

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


def counts(events: list) -> dict[str, int]:
    """Records of each kernel name in a trace."""
    out: dict[str, int] = {}
    for e in events:
        out[e.name] = out.get(e.name, 0) + 1
    return out


def census(fn) -> dict:
    """One call of ``fn`` and two calls, each traced once: the records of each
    trace and every kernel name whose count in the two calls is not twice its
    count in the one, with both counts. A kernel that ``fn`` launches on some
    calls and not on others shows here, and so does a record the profiler lost."""
    one, two = counts(kernel_events(fn, 1)), counts(kernel_events(fn, 2))
    odd = {n: [one.get(n, 0), two.get(n, 0)] for n in sorted(set(one) | set(two)) if two.get(n, 0) != 2 * one.get(n, 0)}
    return {"records_one": sum(one.values()), "records_two": sum(two.values()), "irregular": odd}


def whole_trace(fn, reps: int) -> tuple[list, dict]:
    """The kernel records of ``reps`` calls of ``fn`` from a trace that passed
    ``whole_calls``, and the census that says which kernels it checks: those
    whose count in two calls was twice their count in one. A trace that lost
    a record of one of them is taken again (``kernel_events``); where every
    try failed, the census is taken again, once, and the traces with it."""
    for retake in (False, True):
        c = census(fn)
        try:
            return kernel_events(fn, reps, whole_calls(reps, set(c["irregular"]))), c
        except RuntimeError:
            if retake:
                raise


def by_kernel(events: list, reps: int) -> list[tuple[str, float, float]]:
    """(name, device ms a call, launches a call) of each kernel in ``events``,
    in the order of first start."""
    out: dict[str, list[float]] = {}
    for e in events:
        row = out.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3 / reps
        row[1] += 1
    return [(name, ms, n / reps) for name, (ms, n) in out.items()]
