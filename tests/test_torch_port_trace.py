"""``diagnostics/trace.py``: the profiler's kernel records of a run, taken
again when a trace lost some. The profiler is replaced by a stand-in that
hands out prepared traces, so the logic runs on the CPU."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import pytest
import torch

from mdhs_tpu_torch.diagnostics import trace


def _event(name, start, us, device=True, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    span = SimpleNamespace(start=start, elapsed_us=lambda: us)
    return SimpleNamespace(name=name, time_range=span, device_type=kind, is_user_annotation=annotation)


@pytest.fixture
def traces(monkeypatch):
    """A list to fill with the traces the stand-in profiler returns, in turn;
    the calls of the traced function are counted in ``calls``."""
    queue, calls = [], []

    @contextlib.contextmanager
    def profile(activities):
        yield SimpleNamespace(events=lambda: queue.pop(0))

    monkeypatch.setattr(trace.torch.profiler, "profile", profile)
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace, "PAD_S", 0.0)
    return SimpleNamespace(queue=queue, calls=calls, fn=lambda: calls.append(1))


def test_whole_calls_wants_each_kernel_a_multiple_of_reps():
    ev = [_event("a", 0, 1.0), _event("b", 1, 1.0), _event("a", 2, 1.0), _event("b", 3, 1.0)]
    assert trace.whole_calls(2)(ev) and trace.whole_calls(1)(ev)
    assert not trace.whole_calls(2)(ev[:3]) and not trace.whole_calls(4)(ev)


def test_by_kernel_gives_ms_and_launches_a_call_in_first_start_order():
    ev = [_event("b", 0, 3.0), _event("a", 1, 1.0), _event("b", 2, 5.0), _event("a", 3, 1.0)]
    assert trace.by_kernel(ev, 2) == [("b", 0.004, 1.0), ("a", 0.001, 1.0)]


def test_kernel_events_keeps_device_kernels_in_start_order(traces):
    traces.queue.append([_event("k2", 5, 1.0), _event("cpu_op", 0, 9.0, device=False),
                         _event("Optimizer.step", 1, 9.0, annotation=True), _event("k1", 2, 1.0)])
    events = trace.kernel_events(traces.fn, reps=3)
    assert [e.name for e in events] == ["k1", "k2"]
    assert len(traces.calls) == 1 + 3  # the warm-up call and the traced calls


@pytest.mark.parametrize("lost", [1, trace.TRIES - 1])
def test_kernel_events_traces_again_after_lost_records(traces, lost):
    whole = [_event("k", t, 1.0) for t in range(4)]
    traces.queue.extend([whole[:1]] * lost + [whole])
    events = trace.kernel_events(traces.fn, reps=2, complete=trace.whole_calls(2))
    assert len(events) == 4 and not traces.queue
    assert len(traces.calls) == 1 + 2 * (lost + 1)


def test_kernel_events_raises_when_every_trace_lost_records(traces):
    traces.queue.extend([[_event("k", 0, 1.0)]] * trace.TRIES)
    with pytest.raises(RuntimeError, match=f"each of {trace.TRIES} traces"):
        trace.kernel_events(traces.fn, reps=2, complete=trace.whole_calls(2))
    assert not traces.queue


def test_census_names_kernels_whose_count_does_not_double(traces):
    # one call: a, b, c; two calls: a, b, a, b, c (c once in two calls, or a record lost)
    traces.queue.extend([[_event(n, t, 1.0) for t, n in enumerate("abc")],
                         [_event(n, t, 1.0) for t, n in enumerate("ababc")]])
    assert trace.census(traces.fn) == {"records_one": 3, "records_two": 5, "irregular": {"c": [1, 1]}}
    assert len(traces.calls) == (1 + 1) + (1 + 2)


def test_whole_calls_leaves_out_the_irregular_kernels():
    ev = [_event(n, t, 1.0) for t, n in enumerate("ababc")]
    assert not trace.whole_calls(2)(ev) and trace.whole_calls(2, {"c"})(ev)
    assert not trace.whole_calls(2, {"c"})(ev[:3])  # b lost


def _calls(kernels, n):
    return [_event(k, t, 1.0) for t, k in enumerate(kernels * n)]


@pytest.mark.parametrize("lost", [0, 1])
def test_whole_trace_takes_again_a_trace_that_lost_a_record(traces, lost):
    # the census (one call, two calls), then the traces of 3 calls: the first lost its last record
    # when ``lost``
    whole = _calls("ab", 3)
    traces.queue.extend([_calls("ab", 1), _calls("ab", 2)] + [whole[:-1]] * lost + [whole])
    events, census = trace.whole_trace(traces.fn, 3)
    assert len(events) == 6 and census["irregular"] == {} and not traces.queue
    assert len(traces.calls) == (1 + 1) + (1 + 2) + 1 + 3 * (lost + 1)  # a warm-up call, then each trace


def test_whole_trace_checks_only_the_kernels_every_call_launches(traces):
    # c runs on one call in two: the census finds it, and a trace of 2 calls with one c is whole
    traces.queue.extend([[_event(n, t, 1.0) for t, n in enumerate("abc")],
                         [_event(n, t, 1.0) for t, n in enumerate("ababc")],
                         [_event(n, t, 1.0) for t, n in enumerate("aba")],  # b lost: taken again
                         [_event(n, t, 1.0) for t, n in enumerate("abcab")]])
    events, census = trace.whole_trace(traces.fn, 2)
    assert [e.name for e in events] == list("abcab") and census["irregular"] == {"c": [1, 1]}


def test_whole_trace_takes_the_census_again_where_every_trace_failed(traces):
    # the census finds a, b and c in every call; then c runs on one call in two, so every trace of
    # 2 calls fails the check; a second census finds c irregular, and the next trace passes without it
    def seq(names):
        return [_event(n, t, 1.0) for t, n in enumerate(names)]

    traces.queue.extend([seq("abc"), seq("abcabc")] + [seq("abcab")] * trace.TRIES
                        + [seq("ab"), seq("abcab"), seq("abcab")])
    events, census = trace.whole_trace(traces.fn, 2)
    assert census["irregular"] == {"c": [0, 1]} and [e.name for e in events] == list("abcab")
    assert not traces.queue


def test_whole_trace_raises_where_the_second_census_does_not_help(traces):
    lost = _calls("ab", 2)[:-1]
    traces.queue.extend(([_calls("ab", 1), _calls("ab", 2)] + [lost] * trace.TRIES) * 2)
    with pytest.raises(RuntimeError, match=f"each of {trace.TRIES} traces"):
        trace.whole_trace(traces.fn, 2)
    assert not traces.queue
