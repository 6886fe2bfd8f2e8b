"""The flightline cell's span metrics (``host_bound_s``, ``fcn_model_s``,
``file_io_s``, ``file_io_gbps``) on hand-made span logs: a warm-up tree and
two window trees, none without a ``run_flightline`` tree or without the
program's recorder; and a traced run of the cell on the CPU reports them."""

import sys

import pytest

from portbench import harness

MS = 1_000_000
SPAN_METRICS = ["host_bound_s", "fcn_model_s", "file_io_s", "file_io_gbps"]


def _flightline(t0, model_ms, ids):
    """One flightline's spans (ms from ``t0``), children before parents as
    the log has them: host 3.9 s of 10 s, plus the model's extra time."""
    from srcfinder_torch.trace import Span
    root = next(ids)
    out = []

    def add(name, a, b, parent, **counts):
        s = Span(name, **counts)
        s.span_id, s.parent_id, s.trace_id = next(ids), parent, root
        s.start_ns, s.end_ns = (t0 + a) * MS, (t0 + b) * MS
        out.append(s)
        return s.span_id

    extra = model_ms - 400
    cmf, fcn, ime = next(ids), next(ids), next(ids)
    add("cmf.read", 0, 500, cmf, bytes=10 ** 9)
    add("cmf.h2d", 500, 600, cmf)
    add("cmf.chunk", 600, 1100, cmf)
    add("cmf.stats", 1100, 1150, cmf)
    add("cmf.chunk", 1150, 1650, cmf)
    add("cmf.stats", 1650, 1700, cmf)
    add("cmf.write", 2700, 3000, cmf, bytes=5 * 10 ** 8)
    add("fcn.read", 4000, 4100, fcn, bytes=10 ** 8)
    add("fcn.model", 4100, 4500 + extra, fcn)
    add("fcn.forward", 4500 + extra, 9500 + extra, fcn)
    add("fcn.write", 9500 + extra, 9600 + extra, fcn, bytes=10 ** 8)
    add("ime.read", 10000 + extra, 10200 + extra, ime, bytes=2 * 10 ** 8)
    add("ime.merge", 10200 + extra, 10900 + extra, ime)
    add("ime.write", 10900 + extra, 11000 + extra, ime, bytes=0)
    for name, sid, a, b in (("cmf", cmf, 0, 4000), ("fcn", fcn, 4000, 10000 + extra),
                            ("ime", ime, 10000 + extra, 11000 + extra)):
        s = Span(name)
        s.span_id, s.parent_id, s.trace_id = sid, root, root
        s.start_ns, s.end_ns = (t0 + a) * MS, (t0 + b) * MS
        out.append(s)
    s = Span("run_flightline")
    s.span_id, s.trace_id = root, root
    s.start_ns, s.end_ns = t0 * MS, (t0 + 11000 + extra) * MS
    out.append(s)
    return out


def _log():
    """A warm-up flightline (a 2 s model build), then two in the window
    (0.4 s and 0.6 s), with an unrelated span between them."""
    import itertools

    from srcfinder_torch.trace import Span
    ids = itertools.count(1)
    other = Span("masks")
    other.span_id = other.trace_id = next(ids)
    other.start_ns, other.end_ns = 0, 5 * MS
    return (_flightline(0, 2000, ids) + [other] + _flightline(20000, 400, ids)
            + _flightline(40000, 600, ids))


def _read(name, units):
    return harness.load_module("metrics", name).read(harness.Run(None, 60.0, units, {}, {}))


@pytest.fixture
def hand_log(monkeypatch):
    from srcfinder_torch import trace
    monkeypatch.setattr(trace, "spans", _log)


# the window's two flightlines: 11 s and 11.2 s long, device spans 0.1 + 0.5 +
# 0.5 + 5 s each; files 0.5 + 0.3 + 0.1 + 0.1 + 0.2 + 0.1 s each, carrying
# 1.9e9 bytes each
WANT = {"host_bound_s": ((11.0 - 6.1) + (11.2 - 6.1)) / 2,
        "fcn_model_s": (0.4 + 0.6) / 2,
        "file_io_s": 1.3,
        "file_io_gbps": 2 * 1.9e9 / 2.6e9}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reads_the_window_trees(hand_log, name):
    assert _read(name, 2) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_of_the_last_tree_alone(hand_log, name):
    one = {"host_bound_s": 11.2 - 6.1, "fcn_model_s": 0.6, "file_io_s": 1.3,
           "file_io_gbps": 1.9e9 / 1.3e9}
    assert _read(name, 1) == pytest.approx(one[name], rel=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
@pytest.mark.parametrize("log", ["empty", "no_flightline", "no_units"])
def test_span_metric_is_none_without_a_flightline_tree(monkeypatch, name, log):
    from srcfinder_torch import trace
    spans = {"empty": [], "no_flightline": [s for s in _log() if s.name == "cmf.read"],
             "no_units": _log()}[log]
    monkeypatch.setattr(trace, "spans", lambda: spans)
    assert _read(name, 0 if log == "no_units" else 2) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_is_none_without_the_recorder(monkeypatch, name):
    """A program that has no ``srcfinder_torch.trace`` (as before it had
    one) gives no reading and raises nothing."""
    monkeypatch.setitem(sys.modules, "srcfinder_torch.trace", None)
    assert _read(name, 2) is None


def test_a_traced_flightline_run_reports_the_span_metrics(tiny_tree):
    here, root = tiny_tree
    r = harness.run_cell("flightline-2801-snr-shift", 2 ** 31 + 17, 0.1, 1, device="cpu",
                         here=here, root=root)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert set(SPAN_METRICS) <= set(m)
    assert m["file_io_gbps"]["unit"] == "GB/s" and m["file_io_gbps"]["value"] > 0
    assert 0 < m["fcn_model_s"]["value"] and 0 < m["file_io_s"]["value"]
    assert 0 < m["host_bound_s"]["value"] <= r["device"]["window_s"] / r["attempted"]


@pytest.mark.parametrize("intervals, covered", [
    ([], 0),                                    # nothing covers it
    ([(10, 30), (50, 60)], 30),                 # disjoint
    ([(10, 40), (30, 60)], 50),                 # overlapping: their union
    ([(20, 30), (10, 50)], 40),                 # one inside the other
    ([(-20, 10), (90, 150)], 20),               # clipped to [lo, hi]
    ([(0, 100)], 100),                          # wholly covered
])
def test_covered_ns_is_the_clipped_union(intervals, covered):
    """``host_bound_s``'s arithmetic: a span less the union of the device
    spans inside it."""
    from portbench.program_spans import covered_ns
    lo = 1000
    assert covered_ns([(lo + a, lo + b) for a, b in intervals], lo, lo + 100) == covered
