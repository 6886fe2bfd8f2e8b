"""Geodesy: UTM <-> lat/lon, pixel <-> map coordinate transforms.

Self-contained, vectorized replacement for the reference's geodesy stack
(reference: srcfinder_util.py:815-1024 ``sl2xy``/``xy2sl``/``latlon2sl``/
``mapinfo`` and the external ``LatLongUTMconversion`` module it imports at
srcfinder_util.py:27 but does not ship). UTM conversion uses the standard
Snyder/USGS series on the WGS-84 ellipsoid (the same formulas as the classic
public-domain LLtoUTM/UTMtoLL), vectorized with numpy. The port's copy of
the JAX package's ``core/geo.py``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = [
    "latlon2utm", "utm2latlon", "geo2utmzone", "utmzone2epsg", "epsg2utmzone",
    "sl2xy", "xy2sl", "sl2latlon", "latlon2sl", "latlon2xy", "rotxy",
    "mapinfo", "mapdict2str", "geobbox", "gcdist",
]

DEG2RAD = np.pi / 180.0
RAD2DEG = 180.0 / np.pi

# WGS-84 ellipsoid
_A = 6378137.0
_ECC2 = 0.00669438
_K0 = 0.9996


def geo2utmzone(longitude, latitude):
    """(reference: srcfinder_util.py:666-669)"""
    zone = int(1 + (longitude + 180.0) / 6.0)
    hemi = "N" if latitude >= 0.0 else "S"
    return zone, hemi


def utmzone2epsg(zone, hemi):
    """(reference: srcfinder_util.py:660-662)"""
    assert hemi in ("N", "S")
    return int(("326" if hemi == "N" else "327") + "%02d" % zone)


def epsg2utmzone(epsg):
    """(reference: srcfinder_util.py:664-668)"""
    zone = epsg % 100
    hemi = "N" if epsg < 32700 else "S"
    return zone, hemi


def _utm_letter(lat):
    letters = "CDEFGHJKLMNPQRSTUVWX"
    band = int(np.clip((np.asarray(lat) + 80) // 8, 0, 19))
    return letters[band]


def latlon2utm(lat, lon, zone=None, datum=None):
    """lat/lon (deg) -> (easting, northing, zone, hemi letter).

    Matches the reference surface ``latlon2utm`` (srcfinder_util.py:921-943)
    backed by the classic LLtoUTM Snyder series. Accepts scalars or arrays.
    """
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    # normalize lon into [-180, 180)
    lon_n = (lon + 180.0) - np.floor((lon + 180.0) / 360.0) * 360.0 - 180.0

    if zone is None:
        zone_num = np.floor((lon_n + 180.0) / 6.0).astype(np.int64) + 1
        # Norway exception
        zone_num = np.where((lat >= 56.0) & (lat < 64.0) & (lon_n >= 3.0) & (lon_n < 12.0),
                            32, zone_num)
        # Svalbard exceptions
        sval = (lat >= 72.0) & (lat < 84.0)
        zone_num = np.where(sval & (lon_n >= 0.0) & (lon_n < 9.0), 31, zone_num)
        zone_num = np.where(sval & (lon_n >= 9.0) & (lon_n < 21.0), 33, zone_num)
        zone_num = np.where(sval & (lon_n >= 21.0) & (lon_n < 33.0), 35, zone_num)
        zone_num = np.where(sval & (lon_n >= 33.0) & (lon_n < 42.0), 37, zone_num)
    else:
        zone_num = np.asarray(int(zone))

    lon_origin = (zone_num - 1) * 6.0 - 180.0 + 3.0

    ecc2 = _ECC2
    eccp2 = ecc2 / (1.0 - ecc2)
    lat_r = lat * DEG2RAD
    lon_r = lon_n * DEG2RAD
    lon_o = lon_origin * DEG2RAD

    N = _A / np.sqrt(1.0 - ecc2 * np.sin(lat_r) ** 2)
    T = np.tan(lat_r) ** 2
    C = eccp2 * np.cos(lat_r) ** 2
    Aq = np.cos(lat_r) * (lon_r - lon_o)

    M = _A * (
        (1 - ecc2 / 4 - 3 * ecc2**2 / 64 - 5 * ecc2**3 / 256) * lat_r
        - (3 * ecc2 / 8 + 3 * ecc2**2 / 32 + 45 * ecc2**3 / 1024) * np.sin(2 * lat_r)
        + (15 * ecc2**2 / 256 + 45 * ecc2**3 / 1024) * np.sin(4 * lat_r)
        - (35 * ecc2**3 / 3072) * np.sin(6 * lat_r)
    )

    easting = _K0 * N * (
        Aq + (1 - T + C) * Aq**3 / 6
        + (5 - 18 * T + T**2 + 72 * C - 58 * eccp2) * Aq**5 / 120
    ) + 500000.0
    northing = _K0 * (
        M + N * np.tan(lat_r) * (
            Aq**2 / 2 + (5 - T + 9 * C + 4 * C**2) * Aq**4 / 24
            + (61 - 58 * T + T**2 + 600 * C - 330 * eccp2) * Aq**6 / 720
        )
    )
    northing = np.where(lat < 0, northing + 10000000.0, northing)

    if np.ndim(lat) == 0:
        return float(easting), float(northing), int(zone_num), _utm_letter(float(lat))
    return easting, northing, zone_num, np.where(lat >= 0, "N", "S")


def utm2latlon(easting, northing, zone, hemi="North", alpha=None, datum=None):
    """UTM -> (lat, lon) in degrees (reference: srcfinder_util.py:806-813).

    ``hemi`` accepts 'North'/'South' or 'N'/'S'.
    """
    hemi = str(hemi)
    north = hemi.upper().startswith("N") if alpha is None else (alpha.upper() >= "N")
    easting = np.asarray(easting, dtype=np.float64)
    northing = np.asarray(northing, dtype=np.float64)
    zone = int(zone)

    ecc2 = _ECC2
    eccp2 = ecc2 / (1.0 - ecc2)
    e1 = (1 - np.sqrt(1 - ecc2)) / (1 + np.sqrt(1 - ecc2))

    x = easting - 500000.0
    y = np.where(north, northing, northing - 10000000.0)

    lon_origin = (zone - 1) * 6.0 - 180.0 + 3.0

    M = y / _K0
    mu = M / (_A * (1 - ecc2 / 4 - 3 * ecc2**2 / 64 - 5 * ecc2**3 / 256))
    phi1 = (mu + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
            + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
            + (151 * e1**3 / 96) * np.sin(6 * mu))

    N1 = _A / np.sqrt(1 - ecc2 * np.sin(phi1) ** 2)
    T1 = np.tan(phi1) ** 2
    C1 = eccp2 * np.cos(phi1) ** 2
    R1 = _A * (1 - ecc2) / (1 - ecc2 * np.sin(phi1) ** 2) ** 1.5
    D = x / (N1 * _K0)

    lat = phi1 - (N1 * np.tan(phi1) / R1) * (
        D**2 / 2
        - (5 + 3 * T1 + 10 * C1 - 4 * C1**2 - 9 * eccp2) * D**4 / 24
        + (61 + 90 * T1 + 298 * C1 + 45 * T1**2 - 252 * eccp2 - 3 * C1**2) * D**6 / 720
    )
    lon = (D - (1 + 2 * T1 + C1) * D**3 / 6
           + (5 - 2 * C1 + 28 * T1 - 3 * C1**2 + 8 * eccp2 + 24 * T1**2) * D**5 / 120
           ) / np.cos(phi1)

    lat_deg = lat * RAD2DEG
    lon_deg = lon_origin + lon * RAD2DEG
    if np.ndim(easting) == 0:
        return float(lat_deg), float(lon_deg)
    return lat_deg, lon_deg


def rotxy(x, y, adeg, xc, yc):
    """Rotate point(s) (x, y) about (xc, yc) by ``adeg`` degrees
    (reference: srcfinder_util.py:766-790)."""
    arad = DEG2RAD * adeg
    sinr, cosr = np.sin(arad), np.cos(arad)
    dx, dy = np.asarray(x) - xc, np.asarray(y) - yc
    xp = cosr * dx - sinr * dy
    yp = sinr * dx + cosr * dy
    return xp + xc, yp + yc


def _getmap(kwargs):
    m = kwargs.pop("mapinfo", {}) or {}
    x0 = kwargs.pop("ulx", m.get("ulx"))
    y0 = kwargs.pop("uly", m.get("uly"))
    xps = kwargs.pop("xps", m.get("xps"))
    yps = kwargs.pop("yps", m.get("yps", xps))
    rot = float(kwargs.pop("rot", m.get("rotation", 0)) or 0)
    if x0 is None or y0 is None:
        raise ValueError("ulx or uly undefined")
    if xps is None:
        raise ValueError("xps undefined")
    yps = yps or xps
    return float(x0), float(y0), float(xps), float(yps), rot, m


def sl2xy(s, l, **kwargs):
    """(sample, line) pixel -> (x, y) map coordinate
    (reference: srcfinder_util.py:815-859)."""
    x0, y0, xps, yps, rot, _ = _getmap(kwargs)
    xp, yp = x0 + xps * np.asarray(s), y0 - yps * np.asarray(l)
    if rot == 0:
        return xp, yp
    return rotxy(xp, yp, rot, x0, y0)


def xy2sl(x, y, **kwargs):
    """(x, y) map coordinate -> (sample, line) pixel
    (reference: srcfinder_util.py:879-920)."""
    x0, y0, xps, yps, rot, _ = _getmap(kwargs)
    xp, yp = np.asarray(x) - x0, y0 - np.asarray(y)
    if rot != 0:
        xp, yp = rotxy(xp, yp, rot, 0, 0)
    return xp / xps, yp / yps


def sl2latlon(s, l, **kwargs):
    """(reference: srcfinder_util.py:861-877)"""
    m = kwargs.get("mapinfo", {})
    proj = m.get("proj")
    if not proj:
        raise ValueError("proj undefined")
    x, y = sl2xy(s, l, **dict(kwargs))
    if proj == "Geographic Lat/Lon":
        return y, x
    if proj.upper() == "UTM":
        return utm2latlon(x, y, zone=m["zone"],
                          hemi="North" if str(m["hemi"]).upper().startswith("N") else "South")
    raise ValueError(f'Unknown projection "{proj}"')


def latlon2sl(lat, lon, **kwargs):
    """(reference: srcfinder_util.py:945-959)"""
    m = kwargs.get("mapinfo", {})
    proj = m.get("proj")
    if not proj:
        raise ValueError("proj undefined")
    if proj == "Geographic Lat/Lon":
        return xy2sl(lon, lat, **dict(kwargs))
    zone = int(m["zone"]) if "zone" in m else None
    x, y, _, _ = latlon2utm(lat, lon, zone=zone)
    return xy2sl(x, y, **dict(kwargs))


def latlon2xy(lat, lon, **kwargs):
    """(reference: srcfinder_util.py:961-974)"""
    m = kwargs.get("mapinfo", {})
    proj = m.get("proj")
    if not proj:
        raise ValueError("proj undefined")
    if proj == "Geographic Lat/Lon":
        return lon, lat
    zone = int(m["zone"]) if "zone" in m else None
    x, y, _, _ = latlon2utm(lat, lon, zone=zone)
    return x, y


def mapinfo(img, astype=dict):
    """Parse the ENVI 'map info' metadata list into a dict
    (reference: srcfinder_util.py:987-1024).

    ``img`` may be an EnviImage, a metadata dict, or a path.
    """
    if hasattr(img, "metadata"):
        maplist = img.metadata.get("map info")
    elif isinstance(img, dict):
        maplist = img.get("map info")
    else:
        from .envi import open_envi
        maplist = open_envi(img).metadata.get("map info")

    if maplist is None or astype == list:
        return maplist

    m = OrderedDict()
    m["proj"] = maplist[0]
    m["xtie"] = float(maplist[1])
    m["ytie"] = float(maplist[2])
    m["ulx"] = float(maplist[3])
    m["uly"] = float(maplist[4])
    m["xps"] = float(maplist[5])
    m["yps"] = float(maplist[6])
    if m["proj"] == "UTM":
        m["zone"] = maplist[7]
        m["hemi"] = maplist[8]
        m["datum"] = maplist[9]
    mapmeta = []
    for item in maplist[len(m):]:
        if "=" in item:
            k, v = (s.strip() for s in item.split("=", 1))
            m[k] = v
        else:
            mapmeta.append(item)
    m["rotation"] = float(m.get("rotation", "0"))
    if mapmeta:
        m["metadata"] = mapmeta
    if astype == str:
        return mapdict2str(m)
    return m


def mapdict2str(mapdict):
    """Inverse of :func:`mapinfo` (reference: srcfinder_util.py:976-985)."""
    d = OrderedDict(mapdict)
    mapmeta = d.pop("metadata", [])
    keys, vals = list(d.keys()), list(d.values())
    nargs = 10 if str(d["proj"]).upper() == "UTM" else 7
    maplist = [str(v) for v in vals[:nargs]]
    mapkw = [f"{k}={v}" for k, v in zip(keys[nargs:], vals[nargs:])]
    return "{ " + ", ".join(maplist + mapkw + list(mapmeta)) + " }"


def geobbox(img_or_map, shape=None):
    """lat/lon bounding box of an image (reference: srcfinder_util.py:1210-1224)."""
    if hasattr(img_or_map, "metadata"):
        m = mapinfo(img_or_map)
        nrows, ncols = img_or_map.nrows, img_or_map.ncols
    else:
        m = img_or_map
        nrows, ncols = shape
    corners_sl = [(0, 0), (ncols - 1, 0), (0, nrows - 1), (ncols - 1, nrows - 1)]
    lats, lons = [], []
    for s, l in corners_sl:
        lat, lon = sl2latlon(s, l, mapinfo=m)
        lats.append(lat)
        lons.append(lon)
    return min(lats), max(lats), min(lons), max(lons)


def gcdist(dlon1, dlat1, dlon2, dlat2):
    """Great-circle (haversine) distance in meters
    (reference: srcfinder_util.py:1862-1879)."""
    lon1, lat1, lon2, lat2 = [np.radians(np.asarray(c, dtype=np.float64))
                              for c in (dlon1, dlat1, dlon2, dlat2)]
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    return 12742000.0 * np.arcsin(np.sqrt(a))
