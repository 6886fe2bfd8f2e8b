"""Meteorological-station wind enrichment (Mesowest REST API).

Reference (msf_flow/wind_processor/station_winds.py + windspeed.py:539-619
``stationWindSpeed``): for each plume, query stations within a radius of
the plume during a +-window around the acquisition time (parsed from the
Candidate ID), and record the nearest station's distance and mean wind.

This environment has no egress; the HTTP fetch is injectable (tests pass
a canned-JSON fetcher). Failures fall back to NaN columns exactly like
the reference (windspeed.py:566-619). The port's copy of the JAX
package's ``flow/stations.py``.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import re
from collections import OrderedDict

import numpy as np

from .wind import distance_spherical

__all__ = ["station_wind_speed", "get_station_data_for_plume",
           "plume_datetime_from_cid"]

MESOWEST_URL = ("https://api.synopticdata.com/v2/stations/timeseries"
                "?radius={lat},{lon},{radius}&start={start}&end={end}"
                "&vars=wind_speed&token={token}")


def _urllib_fetch(url: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode())


def plume_datetime_from_cid(cand_id: str) -> _dt.datetime:
    """angYYYYMMDDtHHMMSS-N -> datetime (reference:
    station_winds.py:32-44 datetime regex from Candidate ID)."""
    m = re.search(r"(\d{8})t(\d{6})", cand_id)
    if not m:
        raise ValueError(f"no datetime in candidate id {cand_id}")
    return _dt.datetime.strptime(m[1] + m[2], "%Y%m%d%H%M%S")


def station_wind_speed(lon, lat, begin, end, search_radius_km=10,
                       token=None, fetch=None):
    """Nearest-station mean wind within the radius/time window
    (reference: windspeed.py:539-619). Returns (distance_km, mean_speed),
    NaNs when no data/token/network."""
    token = token or os.environ.get("MESONET_API_TOKEN", "")
    fetch = fetch or _urllib_fetch
    url = MESOWEST_URL.format(lat=lat, lon=lon,
                              radius=search_radius_km,
                              start=begin.strftime("%Y%m%d%H%M"),
                              end=end.strftime("%Y%m%d%H%M"), token=token)
    try:
        data = fetch(url)
        stations = data.get("STATION", [])
        best = (np.nan, np.nan)
        best_d = np.inf
        for st in stations:
            slon = float(st["LONGITUDE"])
            slat = float(st["LATITUDE"])
            speeds = st.get("OBSERVATIONS", {}).get("wind_speed_set_1", [])
            speeds = [s for s in speeds if s is not None]
            if not speeds:
                continue
            d = float(distance_spherical([[lon, lat]], [[slon, slat]])[0, 0])
            if d < best_d:
                best_d = d
                best = (d, float(np.mean(speeds)))
        return best
    except Exception:
        return (np.nan, np.nan)


def get_station_data_for_plume(plume, fill=None, window_min=5,
                               radius_km=20, token=None, fetch=None,
                               cand_id_key="Candidate ID",
                               lat_key="Plume Latitude (deg)",
                               lon_key="Plume Longitude (deg)"):
    """Distance + average-windspeed columns for one plume
    (reference: station_winds.py:47-76: +-5 min window, 20 km radius)."""
    dist_key = "Distance from station (km)"
    speed_key = "Station wind speed (m/s)"
    out = OrderedDict()
    nodata = "NA" if fill is None else str(fill)
    try:
        t = plume_datetime_from_cid(plume[cand_id_key])
        lat = float(plume[lat_key])
        lon = float(plume[lon_key])
    except (KeyError, ValueError):
        out[dist_key] = nodata
        out[speed_key] = nodata
        return out
    begin = t - _dt.timedelta(minutes=window_min)
    end = t + _dt.timedelta(minutes=window_min)
    d, s = station_wind_speed(lon, lat, begin, end, radius_km, token, fetch)
    out[dist_key] = nodata if np.isnan(d) else d
    out[speed_key] = nodata if np.isnan(s) else s
    return out
