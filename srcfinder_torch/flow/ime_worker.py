"""Compute-IME worker: per-detection integrated methane enhancement.

The reference's IME Batch worker lives in an external fork (noted at
msf_flow/deployment/README.md:23-26); its invoke script documents the
job parameters (deployment/compute-ime/invoke-ime:21-33: CMF_DIR,
PPMMTHR=1500, FETCHMAX=150, MERGEDISTS="10 20 50", MINAREA=9) and the
toolkit ships the IME math (srcfinder_util.py:1989-1996) and the
detection filtering it feeds on. This module implements that documented
methodology (Duren et al. 2019 IME/fetch formulation):

for each merge distance d in MERGEDISTS:
  - threshold the CMF at PPMMTHR, drop components under MINAREA px
  - merge components within d pixels (mergelabels)
  - per merged plume: IME (kg), fetch = plume length capped at FETCHMAX m,
    IME/fetch (kg/m), area, centroid lat/lon

The per-plume AvgIMEdivFetch20/StdIMEdivFetch20 columns consumed by
the emission-rate stage are the
mean/std of IME/fetch at the 20 m merge distance (the "20" suffix in
the reference's column names denotes that distance; the nearest
available distance is used when 20 m is not in MERGEDISTS).

Port of the JAX package's ``flow/ime_worker.py`` (host numpy, as there).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..core.morphology import imlabel, mergelabels, remove_small_objects
from ..core.physics import ime
from ..core.geo import sl2latlon

__all__ = ["detection_ime_stats", "compute_ime_for_cmf", "IME_JOB_PARAMS"]

#: documented Batch parameters (reference: deployment/compute-ime/invoke-ime)
IME_JOB_PARAMS = dict(PPMMTHR=1500.0, FETCHMAX=150.0,
                      MERGEDISTS=(10, 20, 50), MINAREA=9)


def _plume_fetch(mask, ps, fetchmax):
    """Plume fetch: the along-maximum-extent length in meters, capped at
    ``fetchmax`` (the documented FETCHMAX=150 cap)."""
    rr, cc = np.nonzero(mask)
    if rr.size == 0:
        return 0.0
    extent = max(rr.max() - rr.min() + 1, cc.max() - cc.min() + 1) * ps
    return float(min(extent, fetchmax))


def _plume_aspect(mask):
    """Bounding-box aspect ratio (minor/major extent) — the "Aspect
    ratio20" validity input of the emission stage, flagged outside
    [0.02, 1] (reference: running_windspeed.py:75-82)."""
    rr, cc = np.nonzero(mask)
    if rr.size == 0:
        return np.nan
    h = rr.max() - rr.min() + 1
    w = cc.max() - cc.min() + 1
    return float(min(h, w) / max(h, w))


def detection_ime_stats(cmf, mapinfo_dict, ppmmthr=None, fetchmax=None,
                        mergedists=None, minarea=None, nodata=-9999.0):
    """Per-plume IME statistics table for one CMF band.

    Returns a DataFrame with one row per (merge distance, plume):
    mergedist, plume id, area px, IME (kg), fetch (m), IMEdivFetch (kg/m),
    centroid row/col and lat/lon.
    """
    p = IME_JOB_PARAMS
    ppmmthr = p["PPMMTHR"] if ppmmthr is None else ppmmthr
    fetchmax = p["FETCHMAX"] if fetchmax is None else fetchmax
    mergedists = p["MERGEDISTS"] if mergedists is None else mergedists
    minarea = p["MINAREA"] if minarea is None else minarea

    cmf = np.asarray(cmf, np.float32)
    valid = cmf != nodata
    ps = float(mapinfo_dict["xps"])
    det = (cmf >= ppmmthr) & valid
    lab0 = remove_small_objects(imlabel(det), min_size=minarea)

    rows = []
    for md in mergedists:
        md_px = max(int(round(md / ps)), 1)
        lab = mergelabels(lab0, md_px)
        for plume_id in np.unique(lab[lab > 0]):
            mask = lab == plume_id
            pix = cmf[mask]
            ime_kg = ime(np.clip(pix, 0, None), ps)
            fetch = _plume_fetch(mask, ps, fetchmax)
            rr, cc = np.nonzero(mask)
            r0, c0 = float(rr.mean()), float(cc.mean())
            lat, lon = sl2latlon(c0, r0, mapinfo=mapinfo_dict)
            rows.append(dict(mergedist_m=md, plume=int(plume_id),
                             area_px=int(mask.sum()), ime_kg=ime_kg,
                             fetch_m=fetch,
                             ime_div_fetch=ime_kg / fetch if fetch else np.nan,
                             aspect=_plume_aspect(mask),
                             row=r0, col=c0, lat=float(lat),
                             lon=float(lon)))
    return pd.DataFrame(rows, columns=[
        "mergedist_m", "plume", "area_px", "ime_kg", "fetch_m",
        "ime_div_fetch", "aspect", "row", "col", "lat", "lon"])


def compute_ime_for_cmf(cmf_path, out_csv=None, **params):
    """CMF product -> IME stats CSV + the AvgIMEdivFetch20/
    StdIMEdivFetch20 summary consumed by the emission-rate stage."""
    from ..core.loaders import loadcmf

    cmf, _, _, m = loadcmf(cmf_path)
    df = detection_ime_stats(cmf, m, **params)
    if out_csv:
        df.to_csv(out_csv, index=False)
    if len(df):
        # the "20" suffix names the 20 m merge distance; use the nearest
        # available distance when 20 m is not in MERGEDISTS
        md = df.mergedist_m.to_numpy(float)
        at20 = df[md == md[np.argmin(np.abs(md - 20.0))]]
        summary = dict(
            **{"AvgIMEdivFetch20 (kg/m)": float(at20.ime_div_fetch.mean()),
               "StdIMEdivFetch20 (kg/m)":
                   float(at20.ime_div_fetch.std(ddof=0))})
    else:
        summary = {"AvgIMEdivFetch20 (kg/m)": np.nan,
                   "StdIMEdivFetch20 (kg/m)": np.nan}
    return df, summary
