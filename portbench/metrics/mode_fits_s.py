"""Seconds a product of the multimodal CMF's per-mode fits: the mean over the
window's products of their summed ``cmf.mode`` spans (K1, eigh, the
whitening, K2 and the apply of each mode, through their kernels)."""

from portbench.product_spans import seconds_per_product


def read(run):
    return seconds_per_product(run, ("cmf.mode",))
