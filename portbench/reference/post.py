"""Plain plume candidates and IME statistics, for the check of the
flightline's plume list and IME table (numpy and scipy.ndimage only).

Candidates (the reference's salience_predictions.py): label the 8-connected
regions of saliency > threshold; in each region's box, the region's pixels
off nodata give the salience min, max, median and MAD; those of them whose
CMF exceeds the ppm*m threshold give the CMF's; the CMF maximum's position
(the centre of mass of the pixels equal to it, truncated) is georeferenced.

IME (compute-ime's documented methodology, Duren et al. 2019): pixels at or
over 1500 ppm*m, 8-connected components of 9 pixels or more, merged where
they lie within d/ps pixels (chessboard) of each other for d in 10, 20, 50 m;
per merged plume its area, IME = sum of ppm*m x ps^2 x 1000 / 22.4 x 0.01604
/ 1e6 kg, fetch = longer box side x ps capped at 150 m, IME / fetch, the box
aspect, the centroid and its latitude and longitude.

Latitude and longitude: UTM to geodetic on WGS-84 by the series of Snyder,
"Map Projections: A Working Manual" (USGS PP 1395, 1987), pp. 63-64.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

EIGHT = np.ones((3, 3), dtype=bool)
WGS84_A, WGS84_E2, UTM_K0 = 6378137.0, 0.00669438, 0.9996


def utm_to_latlon(x, y, zone: int, north: bool = True):
    e2 = WGS84_E2
    ep2 = e2 / (1 - e2)
    e1 = (1 - np.sqrt(1 - e2)) / (1 + np.sqrt(1 - e2))
    x = np.asarray(x, np.float64) - 500000.0
    y = np.asarray(y, np.float64) - (0.0 if north else 10000000.0)
    mu = y / UTM_K0 / (WGS84_A * (1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256))
    p1 = (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu)
          + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu)
          + (151 * e1 ** 3 / 96) * np.sin(6 * mu))
    s, c, t = np.sin(p1), np.cos(p1), np.tan(p1)
    n1 = WGS84_A / np.sqrt(1 - e2 * s ** 2)
    t1, c1 = t ** 2, ep2 * c ** 2
    r1 = WGS84_A * (1 - e2) / (1 - e2 * s ** 2) ** 1.5
    d = x / (n1 * UTM_K0)
    lat = p1 - (n1 * t / r1) * (d ** 2 / 2 - (5 + 3 * t1 + 10 * c1 - 4 * c1 ** 2 - 9 * ep2)
                                * d ** 4 / 24
                                + (61 + 90 * t1 + 298 * c1 + 45 * t1 ** 2 - 252 * ep2
                                   - 3 * c1 ** 2) * d ** 6 / 720)
    lon = (d - (1 + 2 * t1 + c1) * d ** 3 / 6
           + (5 - 2 * c1 + 28 * t1 - 3 * c1 ** 2 + 8 * ep2 + 24 * t1 ** 2) * d ** 5 / 120) / c
    return np.degrees(lat), (zone - 1) * 6.0 - 177.0 + np.degrees(lon)


def pixel_latlon(col, row, geo):
    """(sample, line) -> (lat, lon) for a north-up UTM map info."""
    return utm_to_latlon(geo["ulx"] + geo["ps"] * np.asarray(col, np.float64),
                         geo["uly"] - geo["ps"] * np.asarray(row, np.float64),
                         geo["zone"], geo["north"])


def _stats(pix):
    med = np.median(pix)
    return (np.nanmin(pix), np.nanmax(pix), med,
            np.median(np.abs(np.asarray(pix, np.float64) - med)))


def _max_at(img, mask, value, r0, c0):
    com = ndimage.center_of_mass((img * mask) == value)
    return int(np.int32(com[0])) + r0, int(np.int32(com[1])) + c0


def candidates(sal, cmf, rgb0, sal_thr, cmf_thr, lid, geo, nodata=-9999.0):
    """Rows (id, line, lat, lon, cmf min, max, median, MAD, salience min,
    max, median, MAD) of the plume list. ``sal``: (H, W) saliency;
    ``cmf``: the ppm*m band; ``rgb0``: the product's first band, whose
    nodata marks the scene's."""
    nod = rgb0 == nodata
    lab, _ = ndimage.label(sal > sal_thr, structure=EIGHT)
    rows = []
    for i, box in enumerate(ndimage.find_objects(lab)):
        pm = (lab[box] == i + 1) & ~nod[box]
        s = sal[box].copy()
        if not pm.any():
            continue
        smin, smax, smed, smad = _stats(s[pm])
        r0, c0 = box[0].start, box[1].start
        pr, pc = _max_at(s, pm, smax, r0, c0)
        cm = (cmf[box] > cmf_thr) & pm
        c = cmf[box].copy()
        if cm.any():
            cmin, cmax, cmed, cmad = _stats(c[cm])
            mr, mc = _max_at(c, cm, cmax, r0, c0)
        else:
            cmin = cmax = cmed = cmad = np.nan
            mr, mc = pr, pc
        lat, lon = pixel_latlon(mc, mr, geo)
        rows.append([f"{lid}-{i + 1}", lid, float(lat), float(lon), cmin, cmax, cmed, cmad,
                     smin, smax, smed, smad])
    return rows


def ime_table(cmf, geo, thr=1500.0, fetchmax=150.0, mergedists=(10, 20, 50), minarea=9,
              nodata=-9999.0):
    """Rows (merge distance, plume, area, IME kg, fetch m, IME/fetch, aspect,
    centroid row, col, lat, lon)."""
    ps = geo["ps"]
    det = (cmf >= thr) & (cmf != nodata)
    lab, _ = ndimage.label(det, structure=EIGHT)
    sizes = np.bincount(lab.ravel())
    keep = sizes >= minarea
    keep[0] = False
    plumes = keep[lab]
    scale = 1e-6 * ps * ps * 1000.0 / 22.4 * 0.01604
    rows = []
    for md in mergedists:
        near = ndimage.distance_transform_cdt(~plumes, metric="chessboard") <= max(
            int(round(md / ps)), 1)
        merged, _ = ndimage.label(near, structure=EIGHT)
        # the science code's mergelabels (srcfinder_util.py:425-450) keeps
        # np.unique(regions)[1:]: it drops the background, or the one region
        # where the merge covers the whole scene
        for pid in np.unique(merged)[1:]:
            rr, cc = np.nonzero((merged == pid) & plumes)
            ime = float(np.clip(cmf[rr, cc].astype(np.float64), 0, None).sum() * scale)
            h, w = rr.max() - rr.min() + 1, cc.max() - cc.min() + 1
            fetch = float(min(max(h, w) * ps, fetchmax))
            lat, lon = pixel_latlon(cc.mean(), rr.mean(), geo)
            rows.append([md, int(pid), rr.size, ime, fetch, ime / fetch if fetch else np.nan,
                         min(h, w) / max(h, w), rr.mean(), cc.mean(), float(lat), float(lon)])
    return rows
