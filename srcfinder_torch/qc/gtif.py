"""Web-mercator GeoTIFF cache for the QC app.

Port of the JAX package's ``qc/gtif.py`` (reference:
cmftagger/util.py:408-489 ``img_to_gtif`` + :501-508 ``load_cache_gtif``):
CMF products are warped to EPSG:3857 LZW GeoTIFFs with a lockfile
protocol so multiple app processes share one cache, and precached in
parallel (joblib capped at 4 procs, cmftagger.py:600-616). GDAL is not
available, so the warp is a pure-numpy inverse mapping: build the target
mercator grid over the image's bounds, inverse-project every node (meters
-> lon/lat -> UTM sample/line via core.geo) and nearest-sample the source
— the same nearest resampling gdalwarp defaults to. Host code, as in the
JAX package.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

from ..core.envi import open_envi
from ..core.geo import latlon2sl, mapinfo, sl2latlon
from ..core.geotiff import read_geotiff, write_geotiff
from .labels import lnglat_to_meters, meters_to_lnglat

__all__ = ["img_to_gtif", "load_cache_gtif", "precache_gtifs"]


def _gtif_path(imgf: str, outdir: str) -> str:
    base = os.path.splitext(os.path.basename(imgf))[0]
    return os.path.join(outdir, base + "_epsg3857.tif")


def img_to_gtif(imgf: str, outdir: str, nodata: float = -9999.0,
                overwrite: bool = False, lock_timeout: float = 300.0,
                max_pixels: int = 64_000_000) -> str:
    """Warp an ENVI product to an EPSG:3857 LZW GeoTIFF (cached).

    Lockfile protocol as in the reference (touch {outf}.lock around the
    warp, cmftagger/util.py:458-466): a concurrent caller waits for the
    lock to clear and then reuses the finished file; a lock older than
    ``lock_timeout`` seconds of waiting raises TimeoutError.
    """
    os.makedirs(outdir, exist_ok=True)
    outf = _gtif_path(imgf, outdir)
    lock = outf + ".lock"
    if os.path.isfile(outf) and not overwrite:
        return outf
    # wait out a concurrent warp
    t0 = time.time()
    while os.path.isfile(lock):
        if time.time() - t0 > lock_timeout:
            raise TimeoutError(f"stale gtif lock {lock}")
        time.sleep(0.1)
    if os.path.isfile(outf) and not overwrite:
        return outf

    with open(lock, "w"):
        pass
    try:
        img = open_envi(imgf)
        data = np.asarray(img.load(), np.float32)
        if data.ndim == 2:
            data = data[..., None]
        h, w = data.shape[:2]
        m = mapinfo(img)
        # corner lat/lon -> mercator bbox
        cs = np.array([0, w - 1, 0, w - 1], float)
        cl = np.array([0, 0, h - 1, h - 1], float)
        lat, lon = sl2latlon(cs, cl, mapinfo=m)
        mx, my = lnglat_to_meters(np.asarray(lon), np.asarray(lat))
        x0, x1 = float(mx.min()), float(mx.max())
        y0, y1 = float(my.min()), float(my.max())
        # target resolution: source pixel size inflated by the mercator
        # scale factor 1/cos(lat)
        latc = float(np.mean(lat))
        res = float(m["xps"]) / max(np.cos(np.deg2rad(latc)), 1e-6)
        nx = max(2, int(np.ceil((x1 - x0) / res)) + 1)
        ny = max(2, int(np.ceil((y1 - y0) / res)) + 1)
        if nx * ny > max_pixels:
            raise ValueError(f"gtif target {nx}x{ny} exceeds max_pixels")
        gx = x0 + res * np.arange(nx)
        gy = y1 - res * np.arange(ny)
        GX, GY = np.meshgrid(gx, gy)
        glon, glat = meters_to_lnglat(GX, GY)
        s, l = latlon2sl(glat.ravel(), glon.ravel(), mapinfo=m)
        si = np.rint(np.asarray(s)).astype(np.int64)
        li = np.rint(np.asarray(l)).astype(np.int64)
        inside = (si >= 0) & (si < w) & (li >= 0) & (li < h)
        out = np.full((ny * nx, data.shape[2]), nodata, np.float32)
        out[inside] = data[li[inside], si[inside], :]
        out = out.reshape(ny, nx, data.shape[2])
        gt = (x0 - res / 2, res, 0.0, y1 + res / 2, 0.0, -res)
        write_geotiff(outf, out, nodata=nodata, compress="lzw",
                      geotransform=gt, epsg=3857)
    finally:
        os.remove(lock)
    return outf


def load_cache_gtif(imgf: str, outdir: str, **kwargs):
    """Cached EPSG:3857 load (reference: cmftagger/util.py:501-508) —
    warps on miss, then reads. Returns (array, meta)."""
    outf = img_to_gtif(imgf, outdir, **kwargs)
    return read_geotiff(outf)


def precache_gtifs(imgfs, outdir, workers: int = 4, **kwargs):
    """Parallel precache (reference: joblib Parallel capped at 4 by RAM,
    cmftagger.py:600-616). Returns the list of gtif paths.

    The workers are threads, as the JAX package's are: the LZW codec and
    numpy's array work release the interpreter lock."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(partial(img_to_gtif, outdir=outdir, **kwargs), imgfs))
