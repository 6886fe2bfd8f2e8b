"""Binary/label morphology built on scipy.ndimage.

Replaces the skimage machinery the reference wraps
(reference: srcfinder_util.py:392-450 ``imlabel``/``findobj``/``bwdist``/
``mergelabels``, :1414-1420 ``remove_small_objects``): the part the
plume-list and IME stages run.

skimage is not a dependency; connectivity semantics are reproduced
directly (8-connectivity labeling == scipy label with a full 3x3 structure).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = ["CONN4", "CONN8", "imlabel", "findobj", "disk", "bwdist",
           "mergelabels", "remove_small_objects", "relabel_sequential"]

CONN4 = 1
CONN8 = 2

_STRUCT = {CONN4: ndimage.generate_binary_structure(2, 1),
           CONN8: ndimage.generate_binary_structure(2, 2)}


def imlabel(img, connectivity: int = CONN8):
    """Connected-component labeling (reference: srcfinder_util.py:392-395;
    skimage.measure.label with connectivity=2 by default)."""
    lab, _ = ndimage.label(np.asarray(img) != 0, structure=_STRUCT[connectivity])
    return lab


def findobj(labimg, max_label: int = 0):
    """Bounding slices per label (reference: srcfinder_util.py:397-399)."""
    return ndimage.find_objects(labimg, max_label=max_label)


def disk(radius):
    """Boolean disk structuring element, skimage-compatible
    (x^2 + y^2 <= r^2 footprint)."""
    r = int(radius)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    return (xx * xx + yy * yy) <= r * r


def bwdist(bwimg, metric: str = "euclidean", return_distances=True,
           return_indices=False):
    """Distance transform of the *background of the truthy pixels* —
    matches scipy semantics used by the reference
    (reference: srcfinder_util.py:415-423)."""
    if metric == "euclidean":
        return ndimage.distance_transform_edt(
            bwimg, return_distances=return_distances, return_indices=return_indices)
    if metric in ("chessboard", "taxicab"):
        return ndimage.distance_transform_cdt(
            bwimg, metric=metric,
            return_distances=return_distances, return_indices=return_indices)
    raise ValueError(f"unknown metric {metric}")


def mergelabels(labimg, mergedist, return_merged: bool = False):
    """Merge labeled regions within ``mergedist`` chessboard pixels of each
    other into shared labels (reference: srcfinder_util.py:425-450)."""
    labimg = np.asarray(labimg)
    labmask = labimg != 0
    mergereg = imlabel(bwdist(~labmask, metric="chessboard") <= mergedist)
    mergelab = np.unique(mergereg)[1:]
    mergeimg = np.zeros_like(labimg)
    mergemap = {}
    for mlab, mobj in zip(mergelab, findobj(mergereg)):
        mlmask = (mergereg[mobj] == mlab) & labmask[mobj]
        mergeimg[mobj][mlmask] = mlab
        if return_merged:
            mergemap[mlab] = np.unique(labimg[mobj][mlmask])
    if return_merged:
        return mergeimg, mergemap
    return mergeimg


def remove_small_objects(img, min_size: int, connectivity: int = CONN8):
    """Drop connected components smaller than ``min_size`` pixels
    (reference: srcfinder_util.py:1414-1420; skimage semantics: boolean
    input is labeled first, labeled input is filtered per existing label)."""
    img = np.asarray(img)
    if img.dtype == bool:
        lab = imlabel(img, connectivity=connectivity)
    else:
        lab = img
    if lab.max() == 0:
        return img.copy()
    sizes = np.bincount(lab.ravel())
    keep = sizes >= min_size
    keep[0] = False
    mask = keep[lab]
    out = img.copy()
    out[~mask] = 0 if img.dtype != bool else False
    return out


def relabel_sequential(labimg, offset: int = 1):
    """Relabel to consecutive ids starting at ``offset``
    (reference: srcfinder_util.py:1410-1412; returns (relabeled, fw, inv)
    like skimage where fw/inv are value-lookup arrays)."""
    labimg = np.asarray(labimg)
    labels = np.unique(labimg)
    labels = labels[labels != 0]
    fw = np.zeros(labimg.max() + 1 if labimg.size else 1, dtype=np.int64)
    fw[labels] = np.arange(offset, offset + len(labels))
    inv = np.concatenate([[0], labels])
    return fw[labimg], fw, inv
