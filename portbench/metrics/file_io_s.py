"""Seconds a flightline of file reads and writes: the mean over the window's
flightlines of the summed ``*.read`` and ``*.write`` spans (``cmf.read``,
``cmf.write``, ``fcn.read``, ``fcn.write``, ``salience.read``,
``salience.write``, ``ime.read``, ``ime.write``)."""

from portbench.program_spans import file_spans, mean_per_flightline


def read(run):
    return mean_per_flightline(
        run, lambda root, tree: sum(s.end_ns - s.start_ns for s in file_spans(tree)) / 1e9)
