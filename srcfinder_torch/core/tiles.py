"""Tile extraction and bounding-box helpers (reference:
srcfinder_util.py:681-750 ``pixbox``/``inbbox``/``extract_tile``,
:1998-2040 ``bbox_overlap``/``iou``). The port's copy of the JAX
package's ``core/tiles.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["pixbox", "inbbox", "extract_tile", "bbox_overlap", "iou"]


def pixbox(i, j, ijoff, shape, as_slice: bool = False):
    """Square index box centered at (i, j) with half-width ``ijoff``
    (reference: srcfinder_util.py:681-702)."""
    if isinstance(ijoff, tuple):
        ioff, joff = ijoff
    else:
        ioff = joff = ijoff
    imin, jmin = max(0, i - ioff), max(0, j - joff)
    imax, jmax = i + ioff + 1, j + joff + 1
    if len(shape) >= 2:
        imax, jmax = min(imax, shape[0]), min(jmax, shape[1])
    if as_slice:
        return slice(imin, imax), slice(jmin, jmax)
    return imin, imax, jmin, jmax


def inbbox(ij, shape, ijmin=(0, 0)):
    """(reference: srcfinder_util.py:704-706)"""
    i, j = ij
    return (ijmin[0] <= i < shape[0]) and (ijmin[1] <= j < shape[1])


def extract_tile(img, ul, tdim, transpose=None, fill_value=0):
    """Extract a (tdim, tdim, bands) tile at upper-left ``ul``, padding with
    ``fill_value`` where the tile overlaps the image extent
    (reference: srcfinder_util.py:708-750)."""
    try:
        if len(tdim) == 1:
            tdim = (tdim[0], tdim[0])
    except TypeError:
        tdim = (tdim, tdim)
    assert len(tdim) == 2

    img = np.asarray(img)
    if img.ndim == 3:
        nr, nc, nb = img.shape
    elif img.ndim == 2:
        nr, nc = img.shape
        nb = 1
    else:
        raise ValueError(f"invalid number of image dims {img.ndim}")

    lr = (ul[0] + tdim[0], ul[1] + tdim[1])
    ibeg, iend = max(0, ul[0]), min(nr, lr[0])
    jbeg, jend = max(0, ul[1]), min(nc, lr[1])
    padt, padl = max(0, -ul[0]), max(0, -ul[1])
    padb, padr = padt + (iend - ibeg), padl + (jend - jbeg)

    imgtile = fill_value * np.ones([tdim[0], tdim[1], nb], dtype=img.dtype)
    imgtile[padt:padb, padl:padr] = np.atleast_3d(img[ibeg:iend, jbeg:jend])
    if transpose is not None:
        imgtile = imgtile.transpose(transpose)
    return imgtile


def bbox_overlap(bb1, bb2, pixel_coords: bool = True):
    """Intersection area of two {xmin,xmax,ymin,ymax} boxes
    (reference: srcfinder_util.py:1998-2018)."""
    for bb in (bb1, bb2):
        assert bb["xmin"] < bb["xmax"]
        assert bb["ymin"] < bb["ymax"]
    x_l = max(bb1["xmin"], bb2["xmin"])
    x_r = min(bb1["xmax"], bb2["xmax"])
    y_b = min(bb1["ymax"], bb2["ymax"])
    y_t = max(bb1["ymin"], bb2["ymin"])
    if x_r < x_l or y_b < y_t:
        return 0
    pixel_inc = 1 if pixel_coords else 0
    return (x_r - x_l + pixel_inc) * (y_b - y_t + pixel_inc)


def iou(bb1, bb2, **kwargs):
    """Intersection-over-union; boxes carry width/height
    (reference: srcfinder_util.py:2020-2040)."""
    area_overlap = bbox_overlap(bb1, bb2, **kwargs)
    if area_overlap == 0:
        return 0.0
    area_bb1 = bb1["width"] * bb1["height"]
    area_bb2 = bb2["width"] * bb2["height"]
    val = area_overlap / float(area_bb1 + area_bb2 - area_overlap)
    assert 0.0 <= val <= 1.0
    return val
