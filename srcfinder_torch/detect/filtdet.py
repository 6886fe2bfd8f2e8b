"""KDE-weighted detection filtering.

Port of the JAX package's ``detect/filtdet.py``. Reference
(srcfinder_util.py:1422-1482 ``filtdet`` with module constants
kernel=50, mfmin/mfmax=500/1500, minarea=9, mfminsmall=1250 at :106-109):
gaussian-KDE-weight the CH4 map, clip to [mfmin, mfmax], drop small
components, re-add small components whose raw MF exceeds mfminsmall, and
relabel.

The KDE smoothing (gaussian_filter sigma=k truncate=1) runs as a separable
``conv1d`` on the device; component labeling stays on the host (scipy
union-find — sequential by nature and cheap), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.morphology import imlabel, relabel_sequential, remove_small_objects
from ..device import resolve_device

__all__ = ["kde", "filtdet", "KERNEL", "MFMIN", "MFMAX", "MINAREA",
           "MFMINSMALL", "NODATA"]

# (reference: srcfinder_util.py:104-109)
KERNEL = 50
MFMIN, MFMAX = 500, 1500
MINAREA = 9
MFMINSMALL = 1250
NODATA = -9999


def _symmetric_index(n: int, radius: int, device):
    """Source index of each sample of a length-``n`` axis padded by
    ``radius`` on both sides in numpy's ``'symmetric'`` mode (scipy's
    ``'reflect'``: the edge sample repeats), folding again wherever the pad
    is longer than the axis: the extension has period 2n."""
    i = torch.remainder(torch.arange(-radius, n + radius, device=device), 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _gaussian2d(img, sigma: int, truncate: float = 1.0):
    """Separable gaussian blur matching scipy.ndimage.gaussian_filter
    semantics (radius = truncate*sigma, 'reflect' boundary): along axis 0,
    then axis 1, each a ``conv1d`` over the symmetric-padded rows."""
    radius = int(truncate * sigma + 0.5)
    xx = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (xx / sigma) ** 2)
    k = k / k.sum()

    def rows(a):                      # blur along the last axis
        ap = a[:, _symmetric_index(a.shape[1], radius, a.device)]
        return F.conv1d(ap[:, None, :], k[None, None, :])[:, 0, :]

    return rows(rows(img.T).T)


def kde(img, k: int = KERNEL, device="cuda"):
    """Min-max-normalized gaussian density times the image
    (reference: srcfinder_util.py:1383-1387), as a tensor on ``device``."""
    img = torch.as_tensor(np.asarray(img), device=resolve_device(device))
    sm = _gaussian2d(img, k)
    sm = (sm - sm.min()) / (sm.max() - sm.min())
    return img * sm


def filtdet(ch4mf, nodata_mask, minarea: int = MINAREA, mfmin: float = MFMIN,
            mfmax: float = MFMAX, k: int = KERNEL,
            mfminsmall: float = MFMINSMALL, skip_kde: bool = False,
            use_abs: bool = False, device="cuda"):
    """Filter weakly-connected detections (reference:
    srcfinder_util.py:1422-1482).

    Returns (detkde, detcomp): the clipped KDE-weighted detection image in
    [0,1] and the labeled component image (host numpy). The KDE runs on
    ``device``.
    """
    ch4mf = np.asarray(ch4mf, dtype=np.float32)
    nodata_mask = np.asarray(nodata_mask, bool)
    detkde = np.abs(ch4mf) if use_abs else ch4mf.copy()
    ch4min = ch4mf >= mfmin
    if not skip_kde:
        detkde = kde(detkde, k=k, device=device).cpu().numpy()
    detkde = np.clip((detkde - mfmin) / (mfmax - mfmin), 0.0, 1.0)

    detmask = detkde > 0
    detsmall = detmask.copy()
    detmask = remove_small_objects(detmask, min_size=minarea)
    if mfminsmall >= mfmin:
        # re-add small components whose raw MF is strong
        smallcc = imlabel(detsmall != detmask)
        smallkeep = np.unique(smallcc[ch4mf >= mfminsmall])
        smallkeep = smallkeep[smallkeep != 0]
        smallmask = np.isin(smallcc, smallkeep)
        detmask = detmask | smallmask

    # exclude sub-threshold + nodata afterward so interior holes do not
    # split components
    detcomp = imlabel(detmask)
    detcomp[~ch4min] = 0
    detcomp, _, _ = relabel_sequential(detcomp)

    detkde[~ch4min] = 0
    detkde[nodata_mask] = 0
    detcomp[nodata_mask] = 0
    return detkde, detcomp
