"""Seconds a product of the multimodal CMF's background partition: the mean
over the window's products of their summed ``cmf.pca`` (masked PCA) and
``cmf.kmeans`` (k-means++ seeds and Lloyd's iterations) spans, each through
its kernels."""

from portbench.product_spans import seconds_per_product


def read(run):
    return seconds_per_product(run, ("cmf.pca", "cmf.kmeans"))
