"""Frozen counts of the multimodal CMF product (``robust_mf_image`` with
``bgmodes`` K): per column chunk, the masked PCA, the k-means, and K
unimodal fits, each over the chunk's every line with the mode's mask, as
the program runs them. They read the same work whatever implements it."""

from __future__ import annotations

import math

from .work import PEAK_FLOPS, cmf_chunk_ops, eigh_nominal_ops, k1_work


def pca_ops(L: int, C: int, B: int, P: int) -> int:
    """The masked moments (K1's count), one nominal eigensolve, and the
    projection of the centred spectra onto P axes (2 L B P per column)."""
    return k1_work(L, C, B, 4)[0] + eigh_nominal_ops(C, B) + 2 * L * C * B * P


def kmeans_ops(L: int, C: int, K: int, P: int, iters: int) -> int:
    """k-means++'s seeds (the squared distance to each of the i seeds so
    far, 3 P per point and seed, for i = 1..K-1), then per Lloyd iteration
    the distances' cross term and the centroid sums (2 L C K P each), and
    the last assignment's cross term."""
    seeds = sum(3 * L * C * P * i for i in range(1, K))
    return seeds + iters * 4 * L * C * K * P + 2 * L * C * K * P


def chunk_ops(L: int, C: int, B: int, A: int, K: int, P: int, iters: int) -> int:
    return pca_ops(L, C, B, P) + kmeans_ops(L, C, K, P, iters) + K * cmf_chunk_ops(L, C, B, A)


def product_time_at_peak_s(cfg: dict, traffic: dict, iters: int = 25) -> float:
    """Seconds one product's counted work would take at the peak of its
    precision (f32 at TF32's 495 TFLOP/s, as ``flightline_mfu`` counts
    the CMF): every column chunk, the last padded to a whole chunk as the
    program runs it; ``iters``, the program's Lloyd iterations."""
    chunk = traffic["col_chunk"]
    B = cfg["active_bands"][1] - cfg["active_bands"][0] + 1
    ops = math.ceil(cfg["samples"] / chunk) * chunk_ops(
        cfg["lines"], chunk, B, cfg["alphas"], traffic["bgmodes"], traffic["pcadim"], iters)
    return ops / PEAK_FLOPS[traffic["cmf_dtype"]]
