"""Roofline shares of the CMF kernels K1 (masked moments) and K2 (LOOCV
sweep) over a window of flightlines."""

from __future__ import annotations

import math

from .work import ITEMSIZE, PEAK_CMF_KERNELS, k1_work, k2_work, roofline_s


def nominal_bound_s(cfg, traffic, kernel):
    """Bound of one flightline's nominal launches of ``kernel``: one per
    column chunk, each at the chunk's (lines, col_chunk, active bands)."""
    dtype = traffic["cmf_dtype"]
    L, C = cfg["lines"], traffic["col_chunk"]
    B = cfg["active_bands"][1] - cfg["active_bands"][0] + 1
    ops, nbytes = (k1_work(L, C, B, ITEMSIZE[dtype]) if kernel == "k1"
                   else k2_work(L, C, B, cfg["alphas"], ITEMSIZE[dtype]))
    return math.ceil(cfg["samples"] / C) * roofline_s(ops, nbytes, PEAK_CMF_KERNELS[dtype])


def kernel_share(run, kernel, pattern):
    if run.trace is None or not run.units:
        return None
    s = run.trace.matching_s(pattern)
    if s <= 0:
        return None
    return 100.0 * run.units * nominal_bound_s(run.ctx.cfg, run.ctx.traffic, kernel) / s
