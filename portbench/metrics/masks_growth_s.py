"""Seconds a flightline of the masks' host growth: the mean over the
window's flightlines of the summed ``masks.grow`` (each block's flare
growth) and ``masks.buffer`` (the cloud buffer) spans."""

from portbench.program_spans import mean_per_flightline, window_flightlines

GROWTH = ("masks.grow", "masks.buffer")


def read(run):
    if not any(s.name in GROWTH for _, tree in window_flightlines(run) for s in tree):
        return None
    return mean_per_flightline(
        run, lambda root, tree: sum(s.end_ns - s.start_ns for s in tree
                                    if s.name in GROWTH) / 1e9)
