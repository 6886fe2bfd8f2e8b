"""Seconds a flightline in which the program has nothing queued on the card:
the mean over the window's flightlines of the ``run_flightline`` span's
duration less the union of its device-side spans (``cmf.h2d``, each
``cmf.chunk``, ``fcn.forward``). The rest of the span is host work: the
reads and writes, the CMF's per-chunk host stats, the model build,
salience and IME."""

from portbench.program_spans import DEVICE_SPANS, covered_ns, mean_per_flightline


def _host_s(root, tree):
    device = [(s.start_ns, s.end_ns) for s in tree if s.name in DEVICE_SPANS]
    return (root.end_ns - root.start_ns
            - covered_ns(device, root.start_ns, root.end_ns)) / 1e9


def read(run):
    return mean_per_flightline(run, _host_s)
