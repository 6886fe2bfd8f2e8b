"""The rate of the flightlines' file reads and writes: the ``bytes`` counted
on the window's ``*.read`` and ``*.write`` spans over their seconds, in
GB/s; whether the files move at the page cache's rate."""

from portbench.program_spans import file_spans, window_flightlines


def read(run):
    spans = [s for _, tree in window_flightlines(run) for s in file_spans(tree)]
    ns = sum(s.end_ns - s.start_ns for s in spans)
    if not spans or ns <= 0:
        return None
    return sum(s.counts.get("bytes", 0) for s in spans) / ns
