"""Raster warps without GDAL.

The reference shells ``gdalwarp`` wherever a grid change is needed: the
north-up preprocessing before posthoc downsampling
(cnn/posthoc_down.py:50-60) and the web-mercator QC cache
(cmftagger/util.py:408-489). This module
provides the north-up warp for rotated ENVI map-info rasters using the
in-repo rotation-aware transforms (core.geo sl2xy/xy2sl), with
gdalwarp's default nearest resampling.

Port of the JAX package's ``core/warp.py`` (numpy on the host).
"""

from __future__ import annotations

import numpy as np

from .geo import sl2xy, xy2sl

__all__ = ["warp_north_up"]


def warp_north_up(data, m, nodata: float = -9999.0):
    """Resample a rotated raster onto a north-up grid.

    data: (H, W) or (H, W, B); m: mapinfo dict (core.geo.mapinfo).
    Returns (out_array, out_mapinfo) — if rotation is 0 the inputs come
    back unchanged (the reference's gdalwarp call is likewise a no-op
    then).
    """
    rot = float(m.get("rotation", 0) or 0)
    if rot == 0:
        return data, m
    data = np.asarray(data)
    squeeze = data.ndim == 2
    if squeeze:
        data = data[..., None]
    h, w = data.shape[:2]

    # rotated corners -> north-up bounding box in map coordinates
    cs = np.array([0.0, w - 1, 0.0, w - 1])
    cl = np.array([0.0, 0.0, h - 1, h - 1])
    cx, cy = sl2xy(cs, cl, mapinfo=m)
    xps, yps = float(m["xps"]), float(m["yps"])
    x0, x1 = float(np.min(cx)), float(np.max(cx))
    y0, y1 = float(np.min(cy)), float(np.max(cy))
    nx = int(np.floor((x1 - x0) / xps)) + 1
    ny = int(np.floor((y1 - y0) / yps)) + 1

    gx = x0 + xps * np.arange(nx)
    gy = y1 - yps * np.arange(ny)
    GX, GY = np.meshgrid(gx, gy)
    s, l = xy2sl(GX.ravel(), GY.ravel(), mapinfo=m)
    si = np.rint(np.asarray(s)).astype(np.int64)
    li = np.rint(np.asarray(l)).astype(np.int64)
    inside = (si >= 0) & (si < w) & (li >= 0) & (li < h)
    out = np.full((ny * nx, data.shape[2]), nodata, data.dtype)
    out[inside] = data[li[inside], si[inside], :]
    out = out.reshape(ny, nx, data.shape[2])
    if squeeze:
        out = out[..., 0]

    m2 = dict(m)
    m2["ulx"], m2["uly"] = x0, y1
    m2["rotation"] = 0.0
    return out, m2
