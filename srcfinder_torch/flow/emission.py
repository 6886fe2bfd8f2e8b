"""Plume-level wind statistics and emission rates.

Reference (msf_flow/wind_processor/running_windspeed.py): emission rate =
AvgIMEdivFetch20 (kg/m) x mean wind (m/s) x 3600 (kg/hr) with quadrature
uncertainty from plume/wind coefficients of variation; wind stats come
from the HRRR/RTMA file lists bracketing the candidate's acquisition time.
Port of the JAX package's ``flow/emission.py``; the nearest-cell search
runs on the device ``compute_wind_stats`` is given.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from math import sqrt

from . import wind as windspeed

__all__ = ["WindType", "get_mean_wind_key", "get_std_wind_key",
           "compute_emission_rate", "compute_wind_stats"]


class WindType:
    """Path-based wind dataset typing (reference:
    msf_flow/wind_processor/wind_type.py:1-44)."""

    def __init__(self, path: str):
        base = os.path.basename(os.path.normpath(str(path))).lower()
        full = str(path).lower()
        self._hrrr = "hrrr" in base or "hrrr" in full
        self._rtma = "rtma" in base or "rtma" in full

    def is_hrrr(self):
        return self._hrrr

    def is_rtma(self):
        return self._rtma and not self._hrrr

    def type_as_str(self):
        if self.is_hrrr():
            return "HRRR"
        if self.is_rtma():
            return "RTMA"
        return "UNKNOWN"

    def altitudes(self):
        """HRRR carries 10 m + 80 m winds; RTMA only 10 m."""
        if self.is_hrrr():
            return [10, 80]
        if self.is_rtma():
            return [10]
        return []


def get_mean_wind_key(wind_type, wind_alt, npoints, ntimes):
    """(reference: running_windspeed.py:26-29)"""
    return ("Wind Mean (m/s) [{} {} m, {} nearest points for each of {} "
            "closest times]".format(wind_type, wind_alt, npoints, ntimes))


def get_std_wind_key(wind_type, wind_alt, npoints, ntimes):
    return ("Wind Std (m/s) [{} {} m, {} nearest points for each of {} "
            "closest times]".format(wind_type, wind_alt, npoints, ntimes))


def compute_emission_rate(plume, wind_type, fill=None, default_fill="NA",
                          wind_alt=10, wind_ntimes=3, wind_npoints=10,
                          min_aspect_ratio=0.02, max_aspect_ratio=1.0):
    """Emission rate + uncertainty + aspect-ratio validity flag
    (reference: running_windspeed.py:35-119).

    Recorded deviation (PARITY.md): ``_missing`` treats NaN, empty-string
    and unparsable values as missing (the record gets the fill value);
    the reference with fill=None would raise on ``float('')`` or
    propagate NaN into the emission rate.
    """
    if fill is not None:
        fill = str(fill)
    mean_wind_key = get_mean_wind_key(wind_type, wind_alt, wind_npoints,
                                      wind_ntimes)
    std_wind_key = get_std_wind_key(wind_type, wind_alt, wind_npoints,
                                    wind_ntimes)
    avg_key = "AvgIMEdivFetch20 (kg/m)"
    std_key = "StdIMEdivFetch20 (kg/m)"
    ar_key = "Aspect ratio20"
    er_key = f"Emission Rate (kg/hr) [{wind_type} {wind_alt} m]"
    eu_key = f"Emission Uncertainty (kg/hr) [{wind_type} {wind_alt} m]"

    nodata = default_fill if fill is None else fill

    def _missing(key):
        """Absent, fill-valued, empty-string (csv NaN) or NaN values."""
        if key not in plume:
            return True
        v = plume[key]
        if fill is not None and v == fill:
            return True
        if isinstance(v, str) and v.strip() == "":
            return True
        try:
            import math
            return math.isnan(float(v))
        except (TypeError, ValueError):
            return True

    if _missing(ar_key):
        ar_flag = nodata
    else:
        ar = float(plume[ar_key])
        ar_flag = int((ar > max_aspect_ratio) or (ar < min_aspect_ratio))

    if (_missing(avg_key) or _missing(mean_wind_key)):
        emission_rate = nodata
    else:
        mean_wind = float(plume[mean_wind_key])
        avg_ime = float(plume[avg_key])
        emission_rate = avg_ime * mean_wind * 3600

    if (emission_rate == fill or _missing(std_key)
            or _missing(std_wind_key) or emission_rate == nodata):
        emission_uncertainty = nodata
    else:
        std_wind = float(plume[std_wind_key])
        std_ime = float(plume[std_key])
        plume_cov = 0.0 if avg_ime < 1e-7 else std_ime / avg_ime
        wind_cov = 0.0 if mean_wind < 1e-7 else std_wind / mean_wind
        emission_uncertainty = sqrt(plume_cov ** 2
                                    + wind_cov ** 2) * emission_rate

    stats = OrderedDict()
    stats["Aspect Ratio Flag (0=valid, 1=invalid)"] = ar_flag
    stats[er_key] = emission_rate
    stats[eu_key] = emission_uncertainty
    return stats


def compute_wind_stats(plume, winds_dir, wind_type=None, wind_alt=10,
                       fill=None, default_fill="NA", ntimes=3, npoints=10,
                       lat_key="Plume Latitude (deg)",
                       lon_key="Plume Longitude (deg)",
                       cand_id_key="Candidate ID", ext=".grib2",
                       device="cuda"):
    """Wind mean/std for one plume from bracketing HRRR/RTMA files
    (reference: running_windspeed.py:121-198; file naming
    hrrr.YYYYMMDDHH.wrfsfcf00.grib2 under YYYYMMDD/,
    rtma2p5_ru.YYYYMMDDHHMMz.2dvaranl_ndfd.grib2).

    ``ext`` selects the wind-grid format (.grib2 or .npz); ``device``
    the one the nearest-cell search runs on ("cuda" or "cpu").
    """
    if fill is not None:
        fill = str(fill)
    wt = WindType(winds_dir) if wind_type is None else None
    if wt is not None:
        is_hrrr, wind_type = wt.is_hrrr(), wt.type_as_str()
    else:
        is_hrrr = wind_type.lower() == "hrrr"
        if not (is_hrrr or wind_type.lower() == "rtma"):
            raise ValueError("wind type must be hrrr or rtma")
    if wt is not None and not (wt.is_hrrr() or wt.is_rtma()):
        raise ValueError('Wind directory name must contain either "hrrr" '
                         'or "rtma" (case-insensitive)')

    mean_key = get_mean_wind_key(wind_type, wind_alt, npoints, ntimes)
    std_key = get_std_wind_key(wind_type, wind_alt, npoints, ntimes)
    stats = OrderedDict()
    nodata = default_fill if fill is None else fill

    if (cand_id_key not in plume or lat_key not in plume or
            lon_key not in plume or
            (fill is not None and (plume[cand_id_key] == fill or
                                   plume[lat_key] == fill or
                                   plume[lon_key] == fill))):
        stats[mean_key] = nodata
        stats[std_key] = nodata
        return stats

    # candidate id like angYYYYMMDDtHHMMSS-N -> YYYYMMDDHHMMSS
    # (reference: running_windspeed.py:162)
    cid = plume[cand_id_key]
    string_time = cid[3:11] + cid[12:18]
    bounding = int(ntimes / 2)
    if is_hrrr:
        hrfiles, _ = windspeed.nearst_hm(string_time, bounding, -1,
                                         "numericstring")
        fllist = [os.path.join(winds_dir, h[:8],
                               f"hrrr.{h[:10]}.wrfsfcf00{ext}")
                  for h in hrfiles]
    else:
        _, mnfiles = windspeed.nearst_hm(string_time, -1, bounding,
                                         "numericstring")
        fllist = [os.path.join(winds_dir, m[:8],
                               f"rtma2p5_ru.{m}z.2dvaranl_ndfd{ext}")
                  for m in mnfiles]

    plume_coords = (float(plume[lon_key]), float(plume[lat_key]))
    cur = windspeed.wind_mnstd(npoints, plume_coords, fllist, alt=wind_alt,
                               device=device)
    stats[mean_key] = cur[0]
    stats[std_key] = cur[1]
    return stats
