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

    python -m srcfinder_torch.flow.ime_worker CMF [-o OUT.csv] \
        [--ppmmthr 1500] [--fetchmax 150] [--mergedists "10 20 50"] [--minarea 9]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import pandas as pd

from ..core.morphology import imlabel, mergelabels, remove_small_objects
from ..core.physics import ime
from ..core.geo import gcdist, sl2latlon
from ..trace import span

__all__ = ["detection_ime_stats", "compute_ime_for_cmf",
           "merge_ime_into_plumelist", "IME_JOB_PARAMS", "main"]

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
    with span("ime.label"):
        det = (cmf >= ppmmthr) & valid
        lab0 = remove_small_objects(imlabel(det), min_size=minarea)

    rows = []
    with span("ime.merge"):
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
    StdIMEdivFetch20 summary consumed by the emission-rate stage. Spans
    (:mod:`srcfinder_torch.trace`): "ime.read" (the product, read whole),
    "ime.label" (threshold, labels, small objects), "ime.merge" (the merge
    distances and each plume's statistics) and "ime.write" (the CSV), the
    file spans counting their ``bytes``."""
    from ..core.loaders import loadcmf

    with span("ime.read", bytes=os.path.getsize(cmf_path)):
        cmf, _, _, m = loadcmf(cmf_path)
    df = detection_ime_stats(cmf, m, **params)
    if out_csv:
        with span("ime.write") as s:
            df.to_csv(out_csv, index=False)
            s.count(bytes=os.path.getsize(out_csv))
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


def merge_ime_into_plumelist(plume_df, ime_df, radius_m=150.0):
    """Attach the emission-stage IME columns to a plume candidate list.

    For each candidate, IME rows whose plume centroid lies within
    ``radius_m`` (haversine) are matched; ``AvgIMEdivFetch20 (kg/m)`` /
    ``StdIMEdivFetch20 (kg/m)`` are the mean/std of IME/fetch over the
    matched rows *at the 20 m merge distance* (nearest available
    distance otherwise — the reference's "20" column suffix denotes that
    merge distance), and ``Aspect ratio20`` is the matched aspect at the
    same distance — the three inputs ``compute_emission_rate`` consumes
    (running_windspeed.py:35-119).
    Candidates with no IME match keep NaN (emission stays NA).

    Returns the plume DataFrame with the columns added in place.
    """
    avg_key = "AvgIMEdivFetch20 (kg/m)"
    std_key = "StdIMEdivFetch20 (kg/m)"
    ar_key = "Aspect ratio20"
    for k in (avg_key, std_key, ar_key):
        if k not in plume_df:
            plume_df[k] = np.nan
    if not len(ime_df):
        return plume_df

    ilat = ime_df["lat"].to_numpy(float)
    ilon = ime_df["lon"].to_numpy(float)
    idf = ime_df["ime_div_fetch"].to_numpy(float)
    imd = ime_df["mergedist_m"].to_numpy(float)
    iasp = (ime_df["aspect"].to_numpy(float) if "aspect" in ime_df
            else np.full(len(ime_df), np.nan))

    for i in plume_df.index:
        try:
            plat = float(plume_df.loc[i, "Plume Latitude (deg)"])
            plon = float(plume_df.loc[i, "Plume Longitude (deg)"])
        except (KeyError, TypeError, ValueError):
            continue
        d = gcdist(ilon, ilat, plon, plat)
        near = d <= radius_m
        if not near.any():
            continue
        # all stats at the 20 m merge distance (nearest distance otherwise)
        cand = np.nonzero(near)[0]
        md20 = imd[cand[np.argmin(np.abs(imd[cand] - 20.0))]]
        at20 = cand[imd[cand] == md20]
        vals = idf[at20]
        vals = vals[np.isfinite(vals)]
        if vals.size:
            plume_df.loc[i, avg_key] = float(vals.mean())
            plume_df.loc[i, std_key] = float(vals.std(ddof=0))
        best = at20[np.argmin(d[at20])]
        if np.isfinite(iasp[best]):
            plume_df.loc[i, ar_key] = float(iasp[best])
    return plume_df


def main(argv=None):
    """The compute-ime job surface (parameter names follow
    deployment/compute-ime/invoke-ime:21-33)."""
    p = argparse.ArgumentParser(
        description="Per-plume IME/fetch statistics for a CMF product")
    p.add_argument("cmf", help="4-band CMF ENVI image")
    p.add_argument("-o", "--output", default=None,
                   help="stats CSV (default: <cmf>_ime.csv)")
    p.add_argument("--ppmmthr", type=float,
                   default=IME_JOB_PARAMS["PPMMTHR"])
    p.add_argument("--fetchmax", type=float,
                   default=IME_JOB_PARAMS["FETCHMAX"])
    p.add_argument("--mergedists", default="10 20 50",
                   help='space-separated meters, e.g. "10 20 50"')
    p.add_argument("--minarea", type=int, default=IME_JOB_PARAMS["MINAREA"])
    args = p.parse_args(argv)

    out = args.output or (args.cmf.rsplit(".", 1)[0] + "_ime.csv")
    df, summary = compute_ime_for_cmf(
        args.cmf, out_csv=out, ppmmthr=args.ppmmthr, fetchmax=args.fetchmax,
        mergedists=tuple(float(d) for d in args.mergedists.split()),
        minarea=args.minarea)
    print(f"[INFO] {len(df)} plume rows -> {out}")
    for k, v in summary.items():
        print(f"[INFO] {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
