"""Product loaders + plume-list I/O + artifact-mask sampling.

(reference: srcfinder_util.py:1484-1650 ``loadmaskedimage``/``loadcmf``/
``loadfiltdet``/``loaddetids``/``loadsaliencemap``, :1881-1967
``parse_masks``/``mask2rgb``, :2042-2081 ``load_plumedf``, :1383-1412
``kde``/``absnorm``/``smoothbil``). The port's copy of the JAX package's
``core/loaders.py``.
"""

from __future__ import annotations

import glob as _glob
import os

import numpy as np
import pandas as pd

from .envi import open_envi
from .geo import mapinfo, latlon2sl
from .stats import extrema

__all__ = ["loadcmf", "loadmaskedimage", "loadfiltdet", "loaddetids",
           "loadsaliencemap", "load_plumedf", "parse_masks", "mask2rgb",
           "absnorm", "smoothbil", "retrieve_rgb"]


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


def loadmaskedimage(maskedimgf, rgb_bands=(), masked_value=np.nan,
                    load_bands=(), memmap=False):
    """(reference: srcfinder_util.py:1484-1536)"""
    img = open_envi(maskedimgf)
    bip = img.open_memmap(interleave="bip")
    if memmap:
        data = bip
    elif load_bands:
        data = np.array(bip[..., list(load_bands)], dtype=np.float32)
    else:
        data = np.array(bip, dtype=np.float32)
    if data.ndim == 2:
        data = data[..., None]
    nodata_value = float(img.metadata.get("data ignore value", np.nan))
    nodata_mask = (np.asarray(data) == nodata_value).any(axis=2)
    if not memmap:
        data[nodata_mask] = masked_value
    out = dict(mapinfo=mapinfo(img), nodata_mask=nodata_mask,
               nodata_value=nodata_value)
    bands = data.shape[2]
    rgb_bands = list(rgb_bands)
    if bands >= 3 and len(rgb_bands) == 3:
        image_bands = sorted(set(range(bands)) - set(rgb_bands))
        out["rgb"] = data[:, :, rgb_bands]
        if image_bands:
            out["image"] = data[:, :, image_bands].squeeze()
    else:
        out["image"] = np.asarray(data).squeeze()
    return out


def _load_single_band(imgf, key):
    img = open_envi(imgf)
    arr = np.float32(np.asarray(img.open_memmap(interleave="bip"))).squeeze()
    nodata_value = float(img.metadata.get("data ignore value", -9999))
    nodata_mask = arr == nodata_value
    arr = arr.copy()
    arr[nodata_mask] = 0
    return {key: arr, "mapinfo": mapinfo(img), "nodata_mask": nodata_mask,
            "nodata_value": nodata_value}


def loadfiltdet(detfilt_imgf):
    """(reference: srcfinder_util.py:1593-1602)"""
    return _load_single_band(detfilt_imgf, "ch4det")


def loaddetids(detid_imgf):
    """(reference: srcfinder_util.py:1604-1614)"""
    return _load_single_band(detid_imgf, "detids")


def loadsaliencemap(salience_imgf):
    """(reference: srcfinder_util.py:1616-1622)"""
    img = open_envi(salience_imgf)
    sal = np.float32(np.asarray(img.open_memmap(interleave="bip"))).squeeze()
    return dict(saliencemap=sal, mapinfo=mapinfo(img))


def load_plumedf(plumes_file, cnn_sheet=None, manualid_sheet=None,
                 truncated_cids=True, dedupcols=()):
    """Plume-list reader + dedup (reference: srcfinder_util.py:2042-2081).

    Reads .xlsx through the stdlib reader (core.xlsx — no Excel engine
    needed) and .csv directly."""
    from .labels import LIDCOL, CIDCOL, EVALCOL, LABCOL
    from ..qc.labels import PLUMELAB, FALSELAB
    from .xlsx import read_xlsx

    def _read(sheet):
        if plumes_file.endswith(".csv"):
            return pd.read_csv(plumes_file)
        return read_xlsx(plumes_file, sheet_name=sheet)

    cnndf = _read(cnn_sheet)
    cnndf.columns = cnndf.columns.str.replace("#", "").str.strip()
    if manualid_sheet is not None:
        manualdf = _read(manualid_sheet)
        manualdf.columns = manualdf.columns.str.replace("#", "").str.strip()
        manualdf.loc[:, EVALCOL] = ["FN"] * len(manualdf)
        plumedf = pd.concat([cnndf, manualdf], axis=0)
    else:
        plumedf = cnndf

    if EVALCOL in plumedf:
        plumedf[LABCOL] = [
            PLUMELAB if v else FALSELAB
            for v in np.isin(plumedf[EVALCOL].values, ("TP", "FN"))]

    if CIDCOL in plumedf:
        plumedf[CIDCOL] = [cid.split("-")[-1] if isinstance(cid, str)
                           else str(cid) for cid in plumedf[CIDCOL].values]
        if not truncated_cids:
            plumedf[CIDCOL] = [f"{lid}-{cid}" for lid, cid in
                               plumedf[[LIDCOL, CIDCOL]].values]

    if dedupcols:
        plumedf = plumedf.loc[~plumedf.duplicated(keep="first",
                                                  subset=list(dedupcols))]
    return plumedf


def parse_masks(lid, cid, lat, lon, maskdir, masksuf, maskwin: int = 3):
    """Sample the 4-band artifact masks in a window around each candidate
    (reference: srcfinder_util.py:1881-1954). Returns (DataFrame, mask
    column names)."""
    lid = np.asarray(lid)
    cid = np.asarray(cid)
    lat = np.asarray(lat, float)
    lon = np.asarray(lon, float)
    assert len(lid) == len(lon) == len(lat)
    assert maskwin >= 3 and maskwin % 2 == 1
    maskrad = maskwin // 2
    dfcols = ["lid", "cid", "lat", "lon", "row", "col"]
    maskcols: list = []
    dfout = []
    for ilid in np.unique(lid):
        matches = _glob.glob(os.path.join(maskdir, ilid + "*" + masksuf))
        if not matches:
            continue
        img = open_envi(matches[0])
        bip = img.open_memmap(interleave="bip")
        nodatav = float(img.metadata.get("data ignore value", -9999))
        maskmap = mapinfo(img)
        bands = img.metadata.get("band names",
                                 [f"b{i}" for i in range(img.nbands)])
        if not maskcols:
            maskcols = [str(bn).split()[0] for bn in bands]
        nline, nsamp = img.nrows, img.ncols
        for idx in np.where(lid == ilid)[0]:
            s, l = latlon2sl(lat[idx], lon[idx], mapinfo=maskmap)
            s, l = float(s), float(l)
            lmin = int(max(0, min(round(l) - maskrad, nline - 1)))
            lmax = int(min(l + maskrad + 2, nline - 1))
            smin = int(max(0, min(round(s) - maskrad, nsamp - 1)))
            smax = int(min(s + maskrad + 2, nsamp - 1))
            roi = np.asarray(bip[lmin:lmax, smin:smax])
            roi = (roi != 0) & (roi != nodatav)
            flags = np.uint8(roi.reshape(-1, len(maskcols)).any(axis=0))
            dfout.append([ilid, cid[idx], lat[idx], lon[idx], l, s]
                         + list(flags))
    return pd.DataFrame(dfout, columns=dfcols + maskcols), maskcols


def mask2rgb(imgmask, alpha: float = 1.0):
    """Colorize the 4-band QC mask (reference:
    srcfinder_util.py:1956-1967)."""
    maskbands = ["cloud", "specular", "flare", "dark"]
    maskcolor = dict(cloud=(0.8, 0.8, 0.8, alpha),
                     specular=(0.8, 0.6, 0.2, alpha),
                     flare=(0.9, 0.1, 0.0, alpha),
                     dark=(0.0, 0.0, 0.0, alpha))
    imgmask = np.asarray(imgmask)
    maskrgb = np.zeros(imgmask.shape[:2] + (4,))
    nodata = (imgmask == -9999).all(axis=2)
    for i, band in enumerate(maskbands):
        maski = (imgmask[:, :, i] != 0) & ~nodata
        maskrgb[maski] = maskcolor[band]
    return maskrgb


def absnorm(img, mask):
    """Normalize to the symmetric absolute range
    (reference: srcfinder_util.py:1389-1396)."""
    assert img.ndim == 2
    i32 = np.float32(img)
    imax = np.abs(i32[~mask]).max()
    imin = -imax
    return np.clip((i32 - imin) / (imax - imin), 0.0, 1.0), imin, imax


def smoothbil(img, mask, d, sigma_color, sigma_space, normalize=True):
    """Bilateral smoothing via OpenCV
    (reference: srcfinder_util.py:1398-1408)."""
    from cv2 import bilateralFilter
    if normalize:
        imgn, imin, imax = absnorm(img, mask)
    else:
        imgn = np.float32(img.copy())
        imin, imax = extrema(img[~mask])
    imgn = bilateralFilter(imgn, d, sigma_color, sigma_space)
    return imin + imgn * (imax - imin)


def retrieve_rgb(rgbf, fetcher=None):
    """Fetch an AVIRIS-NG RGB quicklook from avirisng.jpl.nasa.gov
    (reference: srcfinder_util.py:1803-1832). Returns 0 on success
    (including already-present), nonzero on failure, like the
    reference's wget return code.

    ``fetcher(url, dest_path) -> None`` is injectable — this
    environment has no network egress, so the default urllib fetcher is
    only exercised with injected fakes in tests; the URL scheme (y{YY}
    _RGB vs the 2017 qlook path) is the reference's.
    """
    import os
    import re

    if os.path.exists(rgbf):
        return 0
    base = os.path.basename(rgbf)
    m = re.match(r"(ang\d{8}t\d{6})", base)
    if not m:
        raise ValueError("retrieve_rgb only works with AVIRIS-NG "
                         f"flightlines (got {base!r})")
    lid = m.group(1)
    year = lid[5:7]
    url_root = "https://avirisng.jpl.nasa.gov"
    if year != "17":
        url = f"{url_root}/aviris_locator/y{year}_RGB/{base}"
    else:
        url = f"{url_root}/ql/{year}qlook/{lid}_geo.jpeg"

    if fetcher is None:
        def fetcher(u, dest):
            import urllib.request
            urllib.request.urlretrieve(u, dest)

    try:
        os.makedirs(os.path.dirname(rgbf) or ".", exist_ok=True)
        fetcher(url, rgbf)
        return 0 if os.path.exists(rgbf) else 1
    except Exception as e:
        import logging
        logging.getLogger(__name__).warning(
            "retrieve_rgb: %s not found and unable to retrieve (%s)",
            rgbf, e)
        return 1
