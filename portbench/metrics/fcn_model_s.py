"""Seconds a flightline of the FCN stage's model build: the mean over the
window's flightlines of the ``fcn.model`` span (``load_saliency_model``:
the weights file, the network's host init, the BatchNorm fold, the move to
the card)."""

from portbench.program_spans import mean_per_flightline


def read(run):
    return mean_per_flightline(
        run, lambda root, tree: sum(s.end_ns - s.start_ns for s in tree
                                    if s.name == "fcn.model") / 1e9)
