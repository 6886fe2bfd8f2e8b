"""The program's own spans of the window's flightlines, as the flightline
cell's span metrics read them: ``srcfinder_torch.trace.spans()``, grouped
by trace, of the last ``run.units`` ``run_flightline`` roots (the warm-up
flightline of set-up comes before them). A program without the span
recorder, or a run that recorded no flightline, gives none."""

from __future__ import annotations

#: Spans in which the program has work queued on the card: the radiance
#: window's copy, each column chunk's kernels through its copies back, and
#: the FCN's passes through the saliency's copy back.
DEVICE_SPANS = ("cmf.h2d", "cmf.chunk", "fcn.forward")


def window_flightlines(run):
    """[(root, [spans of its trace])] of the window's flightlines, oldest
    first; [] when there are none to read."""
    try:
        from srcfinder_torch.trace import spans
    except ModuleNotFoundError:
        return []
    log = spans()
    roots = [s for s in log if s.name == "run_flightline" and s.parent_id is None]
    roots = roots[-run.units:] if run.units else []
    trees = {r.trace_id: [] for r in roots}
    for s in log:
        if s.trace_id in trees:
            trees[s.trace_id].append(s)
    return [(r, trees[r.trace_id]) for r in roots]


def covered_ns(intervals, lo, hi):
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    covered, reach = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            covered += b - a
            reach = b
    return covered


def file_spans(tree):
    """The spans of a flightline that read or write files."""
    return [s for s in tree if s.name.endswith((".read", ".write"))]


def mean_per_flightline(run, seconds_of):
    """The mean over the window's flightlines of ``seconds_of(root, tree)``,
    or None when there is none."""
    flights = window_flightlines(run)
    if not flights:
        return None
    return sum(seconds_of(root, tree) for root, tree in flights) / len(flights)
