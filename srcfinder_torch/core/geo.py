"""Geodesy: UTM <-> lat/lon, pixel <-> map coordinate transforms.

Self-contained, vectorized replacement for the reference's geodesy stack
(reference: srcfinder_util.py:815-1024 ``sl2xy``/``xy2sl``/``sl2latlon``/
``mapinfo`` and the external ``LatLongUTMconversion`` module it imports at
srcfinder_util.py:27 but does not ship): the pixel -> lat/lon direction the
plume list and IME stages use, the map -> pixel direction of the north-up
warp, and the UTM zone's EPSG code of the GeoTIFF writer. UTM conversion uses the standard
Snyder/USGS series on the WGS-84 ellipsoid (the same formulas as the
classic public-domain UTMtoLL), vectorized with numpy.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = ["utm2latlon", "utmzone2epsg", "sl2xy", "xy2sl", "sl2latlon", "rotxy",
           "mapinfo", "mapdict2str", "gcdist"]

DEG2RAD = np.pi / 180.0
RAD2DEG = 180.0 / np.pi

# WGS-84 ellipsoid
_A = 6378137.0
_ECC2 = 0.00669438
_K0 = 0.9996


def utmzone2epsg(zone, hemi):
    """(reference: srcfinder_util.py:660-662)"""
    assert hemi in ("N", "S")
    return int(("326" if hemi == "N" else "327") + "%02d" % zone)


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


def gcdist(dlon1, dlat1, dlon2, dlat2):
    """Great-circle (haversine) distance in meters
    (reference: srcfinder_util.py:1862-1879)."""
    lon1, lat1, lon2, lat2 = [np.radians(np.asarray(c, dtype=np.float64))
                              for c in (dlon1, dlat1, dlon2, dlat2)]
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    return 12742000.0 * np.arcsin(np.sqrt(a))
