"""Wind math: distance matrices, nearest-point wind statistics, time
bucketing (reference: msf_flow/wind_processor/windspeed.py).

Port of the JAX package's ``flow/wind.py``. The host helpers stay numpy;
the per-plume hot spot, the distance from the plume to every cell of a
full wind grid (~1.9M HRRR cells) and the choice of the k nearest, runs in
torch on the device it is given.

Two deliberate differences from the JAX package, whose ``_nearest_k``
works in float32 and sends grids under 500k cells to the host:

- The distances are spherical cosines in float64, with the plume's
  coordinates in float64: the reference's own precision (windspeed.py:
  142-160, f64 with argsort). At HRRR's 3 km spacing the f32 distance is
  quantised to ~2 km near the plume (``1 - cos`` sits at f32's epsilon),
  so which cells an f32 search picks depends on how a library rounds its
  transcendentals.
- The k nearest are chosen with ties to the lower cell index, as
  ``lax.top_k`` and a stable argsort do: a stable sort of the distances.
  ``torch.topk`` promises no order among equal values.

Every grid, whatever its size, is searched on the device passed in.
"""

from __future__ import annotations

import datetime as _dt
import math

import numpy as np
import torch

from .windgrid import read_wind_grid

__all__ = ["distance_spherical", "distance_index", "nearest_points",
           "wind_mnstd", "plumetime_format", "nearst_hm", "read_plumes",
           "gather_plumes"]

_EQ_RADIUS = 6378.137            # WGS-84 equatorial radius (km)
_POLAR_RADIUS = 6356.7523
_MEAN_RADIUS = (2 * _EQ_RADIUS + _POLAR_RADIUS) / 3


def distance_spherical(x, y, distance_type: str = "haversine"):
    """Pairwise distances in km between (n1, 2) and (n2, 2) [lon, lat]
    coordinate sets (reference: windspeed.py:22-118)."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.atleast_2d(np.asarray(y, np.float64))
    if x.shape[1] != y.shape[1]:
        raise ValueError("locations must have same number of dimensions")
    if distance_type == "euclid":
        return np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    xr, yr = np.radians(x), np.radians(y)
    if distance_type == "sphericalCosines":
        cosang = (np.sin(xr[:, 1:2]) @ np.sin(yr[:, 1:2]).T
                  + (np.cos(xr[:, 1:2]) @ np.cos(yr[:, 1:2]).T)
                  * np.cos(xr[:, 0:1] - yr[:, 0:1].T))
        return _EQ_RADIUS * np.arccos(np.clip(cosang, -1, 1))
    if distance_type == "haversine":
        dlat = xr[:, 1:2] - yr[:, 1:2].T
        dlon = xr[:, 0:1] - yr[:, 0:1].T
        a = (np.sin(dlat / 2) ** 2
             + np.cos(xr[:, 1:2]) * np.cos(yr[:, 1:2].T) * np.sin(dlon / 2) ** 2)
        return _MEAN_RADIUS * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))
    raise ValueError(f"unknown distance_type {distance_type}")


def distance_index(x, y, indx_type: str = "min", dtype: str = "euclid"):
    """(index, distance, sorted [index, dist] array) of nearest/farthest
    point (reference: windspeed.py:122-168). Distances in km for
    'spherical', degrees-euclid otherwise."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.atleast_2d(np.asarray(y, np.float64))
    if dtype == "spherical":
        h = distance_spherical(x, y, "sphericalCosines").T[:, 0]
    else:
        h = np.sqrt(((y - x) ** 2).sum(axis=1))
    order = np.argsort(h)
    dist_index = np.c_[order.astype(np.float64), h[order]]
    if indx_type == "min":
        return dist_index[0, 0], dist_index[0, 1], dist_index
    return dist_index[-1, 0], dist_index[-1, 1], dist_index


def _nearest_k(lon0: float, lat0: float, lons: torch.Tensor, lats: torch.Tensor,
               k: int):
    """Spherical-cosines distances (km, float64) from the plume at
    (``lon0``, ``lat0``) degrees to every cell, and the ``k`` nearest in
    ascending distance, equal distances in ascending cell index."""
    lon0, lat0 = math.radians(lon0), math.radians(lat0)
    lon = torch.deg2rad(lons)
    lat = torch.deg2rad(lats)
    cosang = (math.sin(lat0) * torch.sin(lat)
              + math.cos(lat0) * torch.cos(lat) * torch.cos(lon0 - lon))
    d = _EQ_RADIUS * torch.arccos(cosang.clamp_(-1.0, 1.0))
    d, idx = torch.sort(d, stable=True)
    return d[:k], idx[:k]


def nearest_points(plume_lonlat, grid, k: int, device="cuda"):
    """Distances (km) and F-order cell indices of the ``k`` grid cells
    nearest ``plume_lonlat`` = (lon, lat), searched on ``device``. The
    grid is raveled in Fortran order, as in the JAX package, so an index
    names the same cell there."""
    lon0, lat0 = (float(c) for c in plume_lonlat)
    lons = torch.as_tensor(np.asarray(grid.lon, np.float64).ravel(order="F"),
                           device=device)
    lats = torch.as_tensor(np.asarray(grid.lat, np.float64).ravel(order="F"),
                           device=device)
    d, idx = _nearest_k(lon0, lat0, lons, lats, k)
    return d.cpu().numpy(), idx.cpu().numpy()


def wind_mnstd(npoints: int, plumeloc, files, alt: int = 10, device="cuda"):
    """Mean/std wind speed of the nearest grid points across files
    (reference: windspeed.py:170-333; aggregation cases preserved):

    1. npoints=1, 1 file  -> nearest-point speed, std 0
    2. npoints=1, >1 file -> mean/std over files' nearest points
    3. npoints>1, 1 file  -> mean/std over npoints of that file
    4. npoints>1, >1 file -> mean/std over all npoints x files

    Recorded deviation (intentional bug fix, as in the JAX package): in
    case 2 the reference only fills its grandMeanStd accumulator inside
    the npoints>1 branch (windspeed.py:300-309), so npoints==1 with
    multiple files returns mean=0.0/std=0.0; here ``grand`` is filled
    unconditionally and case 2 returns the true mean/std of the per-file
    nearest points.

    Returns (mean, std, min_index, min_dist, per_file (n,2),
    [(file, [Y,M,D,h,m,s,us]), ...]).
    """
    tfiles = len(files)
    wind_compute = np.zeros((tfiles, 2))
    grand = np.zeros((npoints, tfiles))
    fdates = [0] * tfiles
    mn_idx = mn_dist = None
    for i, path in enumerate(files):
        grid = read_wind_grid(path, alt=alt)
        tm = grid.valid_date
        fdates[i] = [path, [tm.year, tm.month, tm.day, tm.hour, tm.minute,
                            tm.second, tm.microsecond]]
        speed_grid = np.sqrt(grid.u ** 2 + grid.v ** 2)
        speeds = speed_grid.ravel(order="F")
        d, idx = nearest_points(plumeloc, grid, max(npoints, 1), device=device)
        mn_idx, mn_dist = int(idx[0]), float(d[0])
        sel = speeds[idx[:npoints]]
        wind_compute[i] = [sel.mean(), sel.std()]
        grand[:, i] = sel
    grand_flat = grand.ravel(order="F")
    if tfiles == 1:
        mean, std = wind_compute[0]
        if npoints == 1:
            std = 0.0
        return mean, std, mn_idx, mn_dist, wind_compute, fdates
    return (grand_flat.mean(), grand_flat.std(), mn_idx, mn_dist,
            wind_compute, fdates)


def plumetime_format(utc_time, utc_format: str):
    """UTC time parsing (reference: windspeed.py:335-372). Accepts
    '8/21/2018 18:49:59 UTC' (utcstring) or 'YYYYMMDDHHMMSS'
    (numericstring). Returns ([Y, M, D, h, m, s], 'YYYYMMDDHHMMSS')."""
    f = utc_format.lower()
    if f == "utcstring":
        dt = _dt.datetime.strptime(str(utc_time).replace(" UTC", ""),
                                   "%m/%d/%Y %H:%M:%S")
    elif f == "numericstring":
        dt = _dt.datetime.strptime(str(utc_time), "%Y%m%d%H%M%S")
    else:
        raise ValueError("utcFormat must be utcstring or numericstring")
    return ([dt.year, dt.month, dt.day, dt.hour, dt.minute, dt.second],
            dt.strftime("%Y%m%d%H%M%S"))


def _round15(dt: _dt.datetime) -> _dt.datetime:
    dt = dt + _dt.timedelta(minutes=7.5)
    return dt - _dt.timedelta(minutes=dt.minute % 15, seconds=dt.second,
                              microseconds=dt.microsecond)


def nearst_hm(utc_time, bounding_hours: int, bounding_15minutes: int,
              utc_format: str):
    """Bounding HRRR hour strings and RTMA 15-minute strings around a
    plume time (reference: windspeed.py:374-504). Strings are
    'YYYYMMDDHHMM'; the center time comes LAST in each list (matching the
    reference's below/above/median fill order)."""
    ints, _ = plumetime_format(utc_time, utc_format)
    year_, month_, day_, hour_, minute_, second_ = ints

    hour_file = []
    if bounding_hours > 0:
        given = _dt.datetime(year_, month_, day_, hour_)
        for i in range(1, bounding_hours + 1):
            hour_file.append((given - _dt.timedelta(hours=i))
                             .strftime("%Y%m%d%H%M"))
            hour_file.append((given + _dt.timedelta(hours=i))
                             .strftime("%Y%m%d%H%M"))
        hour_file.append(given.strftime("%Y%m%d%H%M"))
    elif bounding_hours == 0:
        hour_file = [_dt.datetime(year_, month_, day_, hour_)
                     .strftime("%Y%m%d%H%M")]

    minute_files = []
    if bounding_15minutes > 0:
        given = _dt.datetime(year_, month_, day_, hour_, minute_, second_)
        for i in range(1, bounding_15minutes + 1):
            minute_files.append(
                _round15(given - _dt.timedelta(minutes=15 * i))
                .strftime("%Y%m%d%H%M"))
            minute_files.append(
                _round15(given + _dt.timedelta(minutes=15 * i))
                .strftime("%Y%m%d%H%M"))
        minute_files.append(_round15(given).strftime("%Y%m%d%H%M"))
    elif bounding_15minutes == 0:
        given = _dt.datetime(year_, month_, day_, hour_, minute_, second_)
        minute_files = [_round15(given).strftime("%Y%m%d%H%M")]

    return hour_file, minute_files


def read_plumes(filename):
    """CSV -> list of dict rows (reference: windspeed.py:506-514)."""
    import csv
    with open(filename, "rt") as fin:
        return list(csv.DictReader(fin, skipinitialspace=True))


def gather_plumes(filelist):
    """(reference: windspeed.py:516-537)"""
    import itertools
    return list(itertools.chain.from_iterable(
        read_plumes(f) for f in filelist))
