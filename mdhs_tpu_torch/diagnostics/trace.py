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

The profiler also loses the first records of a window: a census of one
ConNexT training step lacked that step's first six records (its four
host-to-device copies, the ``arange`` and the compare of its row mask) in
both of its traces, and a trace of two steps that lost one more record than
the census had (a kernel every call launches) failed in every try, the
census taken again losing the same six. So each window opens with
``LEAD_IN`` marker kernels (``torch.cuda._sleep``'s ``spin_kernel``, which
nothing else launches) before the calls, and closes with ``LEAD_OUT`` after
them: a loss at either end takes markers, not the function's records. Late
in a long process the loss at the end grows: 32 closing markers were all
lost in some windows of the last phases, and in one run every try lost
records of the calls too, so the window closes with 1,024 (about 5 ms of
launches). The markers are dropped from the trace. A trace whose first or
last record is not a marker lost more than they cover and is taken again;
where every try lost them, the last try that passes the caller's check is
taken, as without the markers, and says so (``Trace.held`` False).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

PAD_S = 0.02
TRIES = 3
LEAD_IN = 32  # marker kernels before the calls
LEAD_OUT = 1024  # marker kernels after them
MARKER = "spin_kernel"
MARKER_CYCLES = 1000


def markers(n: int = LEAD_IN) -> None:
    """``n`` marker kernels on the current stream."""
    for _ in range(n):
        torch.cuda._sleep(MARKER_CYCLES)


def _is_marker(e) -> bool:
    return MARKER in e.name


class Trace(list):
    """A trace's kernel records; ``held`` is whether the markers at both ends of its
    window survived (so no record of the calls was lost there)."""

    held = True


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
    they started on the device, the window's markers left out, as a
    ``Trace``. ``complete(events)`` says whether a trace holds the whole run
    (``None``: any does); a trace that fails it, or that lost every marker
    at either end, is taken again. After ``TRIES`` tries the last one that
    passed ``complete`` is returned with ``held`` False, and where none did
    this raises."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    passed = None
    for _ in range(TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(PAD_S)
            markers()
            for _ in range(reps):
                fn()
            markers(LEAD_OUT)
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        # a user annotation (torch.optim's "Optimizer.step#Adam.step") spans kernels counted on their own
        traced = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        events = Trace(e for e in traced if not _is_marker(e))
        if complete is None or complete(events):
            if traced and _is_marker(traced[0]) and _is_marker(traced[-1]):
                return events
            passed = events
    if passed is not None:
        passed.held = False
        return passed
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
