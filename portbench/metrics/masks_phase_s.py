"""Seconds a flightline of the fused stage's read and masks phase: the mean
over the window's flightlines of the ``read+masks`` span (the streamed read
of the radiance with the CMF's slab taps, the pixel tests, the flare growth,
the cloud buffer and the mask's write)."""

from portbench.program_spans import mean_per_flightline, window_flightlines


def read(run):
    if not any(s.name == "read+masks" for _, tree in window_flightlines(run) for s in tree):
        return None
    return mean_per_flightline(
        run, lambda root, tree: sum(s.end_ns - s.start_ns for s in tree
                                    if s.name == "read+masks") / 1e9)
