"""srcfinder_torch.trace, the port's span recorder, on the CPU: the tree
(parents, one trace per root, a context per thread), counts,
the bounded log, stages, no ``record_function`` while the profiler is off,
and the profiler's clock shared with the spans' stamps."""

import threading
import time

import pytest
import torch
from torch.autograd import DeviceType

from srcfinder_torch import trace


class _Recorded:
    """A ``record_function`` stand-in that counts what it enters."""

    def __init__(self, entered):
        self.entered = entered

    def __call__(self, name):
        entered = self.entered

        class _Rf:
            def __enter__(self):
                entered.append(name)

            def __exit__(self, *exc):
                return False
        return _Rf()


def _tree():
    """root -> (a -> (a1, a2), b); returns the spans by name."""
    with trace.span("root") as root:
        with trace.span("a") as a:
            with trace.span("a1") as a1:
                pass
            with trace.span("a2") as a2:
                pass
        with trace.span("b") as b:
            pass
    return dict(root=root, a=a, a1=a1, a2=a2, b=b)


@pytest.mark.parametrize("case", ["parents", "one_trace_per_root", "order_in_log",
                                  "intervals_nest", "a_thread_starts_its_own_trace",
                                  "an_exception_closes_and_restores"])
def test_span_tree(case):
    t = _tree()
    if case == "parents":
        assert t["root"].parent_id is None
        assert [t[k].parent_id for k in ("a", "b")] == [t["root"].span_id] * 2
        assert [t[k].parent_id for k in ("a1", "a2")] == [t["a"].span_id] * 2
    elif case == "one_trace_per_root":
        other = _tree()
        assert {s.trace_id for s in t.values()} == {t["root"].span_id}
        assert {s.trace_id for s in other.values()} == {other["root"].span_id}
        assert other["root"].trace_id != t["root"].trace_id
        assert [s.name for s in trace.spans(t["root"].trace_id)] == \
            ["a1", "a2", "a", "b", "root"]
    elif case == "order_in_log":
        assert trace.spans()[-5:] == [t[k] for k in ("a1", "a2", "a", "b", "root")]
    elif case == "intervals_nest":
        for child, parent in (("a", "root"), ("b", "root"), ("a1", "a"), ("a2", "a")):
            assert t[parent].start_ns <= t[child].start_ns <= t[child].end_ns \
                <= t[parent].end_ns
        assert t["a1"].end_ns <= t["a2"].start_ns and t["a"].end_ns <= t["b"].start_ns
    elif case == "a_thread_starts_its_own_trace":
        got = {}
        with trace.span("outer") as outer:
            th = threading.Thread(target=lambda: got.update(s=trace.span("in thread")
                                                            .__enter__()))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
            with trace.span("inner") as inner:
                pass
        assert got["s"].parent_id is None and got["s"].trace_id == got["s"].span_id
        assert inner.parent_id == outer.span_id
    else:
        with pytest.raises(ValueError):
            with trace.span("outer") as outer:
                with trace.span("raises") as bad:
                    raise ValueError("x")
        assert bad.end_ns is not None and outer.end_ns is not None
        with trace.span("after") as after:
            pass
        assert after.parent_id is None and trace.spans()[-3:] == [bad, outer, after]


@pytest.mark.parametrize("at_entry, later, want", [
    ({}, [], {}),
    ({"bytes": 7}, [], {"bytes": 7}),
    ({}, [{"bytes": 3}, {"bytes": 4}], {"bytes": 7}),
    ({"bytes": 1}, [{"bytes": 2, "rows": 5}], {"bytes": 3, "rows": 5}),
])
def test_counts_at_entry_and_added_later(at_entry, later, want):
    with trace.span("counted", **at_entry) as s:
        for c in later:
            assert s.count(**c) is s
    assert s.counts == want and trace.spans()[-1].counts == want


@pytest.mark.parametrize("n", [1, trace.LOG_SIZE, trace.LOG_SIZE + 1, 3 * trace.LOG_SIZE + 5])
def test_the_log_is_bounded(n):
    for i in range(n):
        with trace.span(f"n{i}"):
            pass
    log = trace.spans()
    assert len(log) <= trace.LOG_SIZE
    if n >= trace.LOG_SIZE:
        assert len(log) == trace.LOG_SIZE
    assert [s.name for s in log[-min(n, trace.LOG_SIZE):]] == \
        [f"n{i}" for i in range(max(0, n - trace.LOG_SIZE), n)]


@pytest.mark.parametrize("profiling", [False, True])
def test_record_function_only_while_the_profiler_records(monkeypatch, profiling):
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Recorded(entered))
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", lambda: profiling)
    _tree()
    with trace.Stage("stage", {}, lambda msg: None):
        pass
    assert entered == (["root", "a", "a1", "a2", "b", "stage"] if profiling else [])


def test_no_record_function_with_the_profiler_really_off(monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Recorded(entered))
    _tree()
    assert entered == []


@pytest.mark.parametrize("name", ["root", "a", "a1", "b"])
def test_span_edges_match_the_profilers_events(name):
    """The spans' ``time.time_ns()`` stamps and the profiler's events of the
    same name agree within 1 ms at both edges."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):   # a process's first
        with trace.span("warm-up"):                     # record_function is slow
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("root") as root:
            with trace.span("a") as a:
                with trace.span("a1") as a1:
                    time.sleep(0.02)
            with trace.span("b") as b:
                time.sleep(0.01)
    mine = dict(root=root, a=a, a1=a1, b=b)[name]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == name and e.device_type() == DeviceType.CPU]
    assert len(events) == 1
    e = events[0]
    assert abs(e.start_ns() - mine.start_ns) < 1_000_000
    assert abs(e.end_ns() - mine.end_ns) < 1_000_000


@pytest.mark.parametrize("fails", [False, True])
def test_stage_announces_times_and_closes(fails):
    timers, log = {}, []
    with trace.span("run") as run:
        try:
            with trace.Stage("cmf", timers, log.append, device=torch.device("cpu")) as st:
                assert log == ["[STAGE] cmf"]
                with trace.span("cmf.read", bytes=10):
                    time.sleep(0.002)
                if fails:
                    raise RuntimeError("stage failed")
        except RuntimeError:
            assert fails
    assert timers == {"cmf": st.seconds} and st.seconds >= 0.002
    assert log == ["[STAGE] cmf", f"[STAGE] cmf done in {st.seconds:.1f}s"]
    assert st.parent_id == run.span_id and trace.spans()[-1] is run
    assert [s.name for s in trace.spans(run.trace_id)] == ["cmf.read", "cmf", "run"]


@pytest.mark.parametrize("device,fails,waits", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False), (None, False, False)])
def test_device_span_waits_for_its_card_before_it_ends(monkeypatch, device, fails, waits):
    """A ``DeviceSpan`` on a CUDA device synchronises that device on a clean
    exit, before its end is stamped; on the CPU, with no device or when it
    fails it waits for nothing."""
    dev = None if device is None else torch.device(device, 0)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d: synced.append((d, time.time_ns())))
    try:
        with trace.DeviceSpan("cmf.mode", dev, rows=3) as s:
            if fails:
                raise RuntimeError("fit failed")
    except RuntimeError:
        assert fails
    assert trace.spans()[-1] is s and s.counts == {"rows": 3}
    if waits:
        ((d, at),) = synced
        assert d == dev and s.start_ns <= at <= s.end_ns
    else:
        assert synced == []


def test_prefetcher_reader_spans_nest_in_the_callers_span():
    """The block reader's thread runs in a copy of the caller's context: a
    span its ``read_fn`` opens is a child of the span open around the loop,
    in the same trace, and the caller's own spans still nest as before."""
    import numpy as np
    from srcfinder_torch.core.prefetch import BlockPrefetcher

    def read(i):
        with trace.span("read", bytes=i):
            return np.full(2, i)
    with trace.span("phase") as phase:
        for i, _ in BlockPrefetcher(read, 3):
            with trace.span("use"):
                pass
    kids = [s for s in trace.spans(phase.trace_id) if s.parent_id == phase.span_id]
    assert sorted(s.name for s in kids) == ["read"] * 3 + ["use"] * 3
    assert sorted(s.counts["bytes"] for s in kids if s.name == "read") == [0, 1, 2]
    assert all(phase.start_ns <= s.start_ns <= s.end_ns <= phase.end_ns for s in kids)
    assert trace._open.get() is None
