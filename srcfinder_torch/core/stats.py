"""Small robust-statistics helpers (reference: srcfinder_util.py:637-658
``counts``/``extrema``, :1372-1381 ``mad``)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = ["counts", "extrema", "mad"]

#: unbiasing constant: Phi^-1(3/4), so mad/c estimates sigma for normals
MAD_C = 0.67448975019608171


def counts(a, sort: bool = True):
    """Value -> occurrence-count ordered dict (reference: srcfinder_util.py:637-645)."""
    c = OrderedDict()
    uvals, unums = np.unique(a, return_counts=True)
    ncz = zip(unums, uvals)
    if sort:
        ncz = sorted(ncz, key=lambda t: (t[0], t[1]))
    for num, val in ncz:
        c[val] = num
    return c


def extrema(a, p: float = 1.0, buf: float = 0.0, axis=None):
    """(vmin, vmax), optionally as nan-percentiles with symmetric tail ``p``
    (reference: srcfinder_util.py:647-658)."""
    if p == 1.0:
        vmin, vmax = np.nanmin(a, axis=axis), np.nanmax(a, axis=axis)
    else:
        assert 0.0 < p < 1.0
        vmin = np.nanpercentile(a, axis=axis, q=(1 - p) * 100, method="nearest")
        vmax = np.nanpercentile(a, axis=axis, q=p * 100, method="nearest")
    if buf != 0:
        vbuf = (vmax - vmin) * buf
        vmin, vmax = vmin - vbuf, vmax + vbuf
    return vmin, vmax


def mad(a, axis: int = 0, medval=None, unbiased: bool = False):
    """Median absolute deviation (reference: srcfinder_util.py:1372-1381;
    statsmodels.robust.scale.mad semantics: median(|a - center|) / c)."""
    a = np.asarray(a, dtype=np.float64)
    center = medval if medval is not None else np.median(a, axis=axis)
    if np.ndim(center) == a.ndim - 1:
        center = np.expand_dims(center, axis)
    c = MAD_C if unbiased else 1.0
    return np.median(np.abs(a - center), axis=axis) / c
