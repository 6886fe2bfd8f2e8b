"""Product loaders (reference: srcfinder_util.py:1624-1635 ``loadcmf``)."""

from __future__ import annotations

import numpy as np

from .envi import open_envi
from .geo import mapinfo

__all__ = ["loadcmf"]


def loadcmf(filepath, rdnmin=0, rdnmax=15):
    """4-band CMF product -> (cmf, rgba, nodata mask, mapinfo)
    (reference: srcfinder_util.py:1624-1635)."""
    img = open_envi(filepath)
    dat = np.asarray(img.open_memmap(interleave="bip"))
    if dat.shape[2] != 4:
        raise ValueError(f"expected a 4-band CMF product, got {dat.shape[2]} bands")
    imgmap = mapinfo(img)
    nodata_value = float(img.metadata.get("data ignore value", -9999))
    cmf = np.float32(dat[..., 3])
    nodata = cmf == nodata_value
    rgb = np.float32(dat[..., :3])
    rgb = np.clip((rgb - rdnmin) / (rdnmax - rdnmin), 0.0, 1.0)
    rgb = np.dstack([rgb, np.float32(nodata == 0)])
    return cmf, rgb, nodata, imgmap
