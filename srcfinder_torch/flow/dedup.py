"""Duplicate/overlapping plume filtering (Duren et al. SI S2.5/S2.8).

Reference (msf_flow/plume_processor/filter_plumes/remove_duplicate_plumes.py,
translated there from the R originals): plumes become points reprojected
from WGS-84 to California Teale Albers, buffered by 150 m; pairwise
percentage overlap drives a recursive filter per uniqueID group
(facility + line name): >2 overlapping -> drop the max-overlap plume and
recurse; exactly 2 -> keep the higher-flux plume (NaN loses).

The reference needs GEOS (shapely/geopandas) for buffer/intersection;
since the buffers of POINTS are circles of equal radius, intersection
areas here are the analytic circle-lens formula — no geometry engine, and
the all-pairs overlap matrix is one vectorized computation. The port's
copy of the JAX package's ``flow/dedup.py``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

__all__ = ["teale_albers", "circle_overlap_fraction", "overlap_matrix",
           "calculate_overlap", "filter_plumes_recursive", "filter_plumes",
           "remove_duplicate_plumes"]

#: max allowable fractional overlap between plume search radii before
#: the duplicate filter engages (reference:
#: remove_duplicate_plumes.py:36 ``max_overlap_default = .30``)
MAX_OVERLAP_DEFAULT = 0.30
BUFFER_M = 150.0

# California Teale Albers (EPSG:3310): NAD83/GRS80 Albers equal-area
_A = 6378137.0
_F = 1 / 298.257222101
_E2 = 2 * _F - _F * _F
_LAT0, _LON0 = 0.0, -120.0
_SP1, _SP2 = 34.0, 40.5
_FE, _FN = 0.0, -4000000.0


def _q(phi):
    e = np.sqrt(_E2)
    s = np.sin(phi)
    return (1 - _E2) * (s / (1 - _E2 * s * s)
                        - (1 / (2 * e)) * np.log((1 - e * s) / (1 + e * s)))


def teale_albers(lat, lon):
    """WGS-84/NAD83 lat/lon (deg) -> EPSG:3310 x/y meters (Snyder Albers
    equal-area conic; the reference reprojects with pyproj via geopandas,
    remove_duplicate_plumes.py:36-38)."""
    lat = np.radians(np.asarray(lat, np.float64))
    lon = np.radians(np.asarray(lon, np.float64))
    phi1, phi2 = np.radians(_SP1), np.radians(_SP2)
    phi0, lam0 = np.radians(_LAT0), np.radians(_LON0)
    m1 = np.cos(phi1) / np.sqrt(1 - _E2 * np.sin(phi1) ** 2)
    m2 = np.cos(phi2) / np.sqrt(1 - _E2 * np.sin(phi2) ** 2)
    q0, q1, q2 = _q(phi0), _q(phi1), _q(phi2)
    n = (m1 * m1 - m2 * m2) / (q2 - q1)
    Cc = m1 * m1 + n * q1
    rho0 = _A * np.sqrt(Cc - n * q0) / n
    q = _q(lat)
    rho = _A * np.sqrt(Cc - n * q) / n
    theta = n * (lon - lam0)
    x = _FE + rho * np.sin(theta)
    y = _FN + rho0 - rho * np.cos(theta)
    return x, y


def circle_overlap_fraction(d, r: float = BUFFER_M):
    """Fraction of a circle's area covered by another equal circle at
    center distance d (lens area / circle area)."""
    d = np.asarray(d, np.float64)
    with np.errstate(invalid="ignore"):
        lens = 2 * r * r * np.arccos(np.clip(d / (2 * r), -1, 1)) \
            - (d / 2) * np.sqrt(np.maximum(4 * r * r - d * d, 0.0))
    frac = lens / (np.pi * r * r)
    return np.where(d >= 2 * r, 0.0, frac)


def overlap_matrix(x, y, r: float = BUFFER_M):
    """All-pairs overlap fractions for points (x, y)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    d = np.sqrt((x[:, None] - x[None, :]) ** 2
                + (y[:, None] - y[None, :]) ** 2)
    ov = circle_overlap_fraction(d, r)
    np.fill_diagonal(ov, 0.0)
    return ov


def calculate_overlap(df, r: float = BUFFER_M,
                      lat_key="Plume Latitude (deg)",
                      lon_key="Plume Longitude (deg)",
                      sid_key="Source identifier"):
    """Per-plume overlap with its first intersecting neighbor (the
    reference records ``pct_overlap.iloc[0]`` — the FIRST overlapping
    polygon's fraction, remove_duplicate_plumes.py:206-248)."""
    x, y = teale_albers(df[lat_key].astype(float).values,
                        df[lon_key].astype(float).values)
    ov = overlap_matrix(x, y, r)
    firsts = np.zeros(len(df))
    for i in range(len(df)):
        nz = np.flatnonzero(ov[i] > 0)
        if len(nz):
            firsts[i] = ov[i, nz[0]]
    return pd.DataFrame({"SID": df[sid_key].values, "V2": firsts},
                        index=df.index)


def filter_plumes_recursive(overlaps, data, flux_colname,
                            max_overlap: float = MAX_OVERLAP_DEFAULT,
                            r: float = BUFFER_M):
    """(reference: remove_duplicate_plumes.py:250-335)"""
    filtered = overlaps[overlaps.V2 > max_overlap]
    if len(data) <= 1 or len(filtered) == 0:
        return data
    if len(filtered) <= 2:
        overlaps = overlaps.copy()
        dups = overlaps[overlaps.duplicated(subset=["V2"])]
        for col in flux_colname:
            overlaps[col] = data[col]
        if len(dups) > 0:
            overlaps["flux_min"] = overlaps[flux_colname].min(axis=1)
            data = data.copy()
            data["flux_min"] = data[flux_colname].min(axis=1)
            for index, row in dups.iterrows():
                source1 = row["SID"]
                flux1 = overlaps.loc[index]
                flux2 = overlaps[overlaps["V2"] == flux1["V2"]]
                flux2 = flux2[flux2["SID"] != source1]
                if len(flux2) == 0:
                    continue
                source2 = flux2["SID"].iloc[0]
                subset = overlaps[overlaps["SID"].isin([source1, source2])]
                nans = subset[subset["flux_min"].apply(
                    lambda v: bool(np.isnan(v)))]
                if len(nans) > 0:
                    nans_sid = nans["SID"].iloc[0]
                    data = data[data["Source identifier"] != nans_sid]
                else:
                    min_flux = subset["flux_min"].min()
                    data = data[data["flux_min"] != min_flux]
            return data.drop(columns=["flux_min"])
        overlaps["flux_max"] = overlaps[flux_colname].max(axis=1)
        lower_flux = overlaps[flux_colname].max(axis=1).min()
        return data[overlaps["flux_max"] != lower_flux]

    # > 2 overlapping: drop the max-overlap plume and recurse
    worst = overlaps["V2"].idxmax()
    data = data.drop([worst])
    overlaps = calculate_overlap(data, r)
    return filter_plumes_recursive(overlaps, data, flux_colname,
                                   max_overlap, r)


def filter_plumes(data, flux_colname, r: float = BUFFER_M,
                  max_overlap: float = MAX_OVERLAP_DEFAULT):
    """One uniqueID group: keep plumes with flux > 1 in some flux column,
    then recursively deduplicate (reference:
    remove_duplicate_plumes.py:448-475; its filter_plumes pins
    max_overlap_default at :351)."""
    mask = np.zeros(len(data), bool)
    for col in flux_colname:
        vals = pd.to_numeric(data[col], errors="coerce")
        mask |= (vals > 1).values
    data = data[mask]
    if len(data) == 0:
        return data
    overlaps = calculate_overlap(data, r)
    return filter_plumes_recursive(overlaps, data, flux_colname,
                                   max_overlap=max_overlap, r=r)


def remove_duplicate_plumes(df, r: float = BUFFER_M,
                            max_overlap: float = MAX_OVERLAP_DEFAULT):
    """Full pipeline over a plume-list dataframe (reference:
    remove_duplicate_plumes.py:390-500): build uniqueID = facility+line,
    uniquify source ids with the candidate suffix, group, filter each
    group, and concatenate."""
    df = df.copy()
    line = df["# Line name"] if "# Line name" in df else df["Line name"]
    if "Nearest facility (best estimate)" in df:
        fac = df["Nearest facility (best estimate)"]
        df["uniqueID"] = [str(f) + str(l) for f, l in zip(fac, line)]
    else:
        df["uniqueID"] = line
    df["Flight_Run"] = line

    sid = df["Source ID"] if "Source ID" in df else df["Source identifier"]
    cid = df["Candidate ID"]
    df["Source identifier"] = [str(s) + str(c)[-2:]
                               for s, c in zip(sid, cid)]
    df = df.replace("#VALUE!", np.nan)

    flux_colname = ([c for c in df.columns if "m wind: E (kg/hr)" in c]
                    + [c for c in df.columns
                       if "Emission Rate (kg/hr) [HRRR" in c])
    for col in flux_colname:
        df[col] = pd.to_numeric(df[col], errors="coerce")

    out = []
    for _, group in df.groupby("uniqueID"):
        kept = filter_plumes(group, flux_colname, r, max_overlap)
        if len(kept):
            out.append(kept)
    if not out:
        return df.iloc[0:0]
    return pd.concat(out).sort_index()
