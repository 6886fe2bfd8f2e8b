"""Plain spectrometer QC masks, for the check of the flightline's 4-band
mask product: [cloud (buffered), specular, flare, dark], int16, with the
radiance's nodata pixels (band 0 at -9999) stamped -9999 in every band.

The semantics are srcfinder's ``spectrometer_masks/masks_sds.py``:

- per-pixel tests in float32 against float32 thresholds: saturated where
  any band of the saturation window (1945-2485 nm) reads above 6; cloud
  where the 450 nm band reads above 15 and both spectral slopes, 450 -> 670
  nm and 670 -> 1250 nm, are negative (the script's documented intent; its
  ``np.logical_and(a, b, c)`` writes into ``c`` and so applies only the
  first slope); specular where saturated and the 505 nm band reads above
  9; dark where the 2139 nm band reads below 0.104 and is not nodata;
- the flightline in blocks of ``block_step`` lines plus an overlap of
  ceil(mingrowarea + grow radius) lines; in each block the saturated
  regions (8-connected) of at least ``mingrowarea`` pixels, less the pixels
  whose 505 nm band reads at least 9 (glint), seed the flare growth: 2
  within the grow radius of a seed, then 1 on saturated pixels that are not
  specular; the blocks merge by their maximum;
- the cloud mask buffered by the cloud radius, in pixels.

Two departures from the usual code keep this independent of the program;
both give the same sets exactly. The flare growth is the seeds' Euclidean
distance transform at most r (the disk x^2 + y^2 <= r^2 about every seed),
and the cloud buffer the taxicab distance transform at most r (r passes of
the 3 x 3 cross).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

F32 = np.float32
SATURATION = 6.0
SATURATION_NM = (1945.0, 2485.0)
CLOUD = 15.0
CLOUD_NM = (450.0, 670.0, 1250.0)
DARK = 0.104
DARK_NM = 2139.0
SPECULAR = 9.0
SPECULAR_NM = 505.0
NODATA = -9999.0


def radius_px(value: str, pixel_m: float) -> float:
    """'150m' or '10px' as pixels: ceil of the metres over the pixel size."""
    if value.endswith("px"):
        return float(math.ceil(float(value[:-2])))
    return float(math.ceil(float(value[:-1]) / pixel_m))


def bands(wavelengths):
    """Band indices of the tests: the saturation window, the three cloud
    bands, the specular band and the dark band (nearest centres)."""
    wl = np.asarray(wavelengths, np.float64)
    w32 = wl.astype(F32)

    def nearest(nm):
        return int(np.argmin(np.abs(wl - nm)))
    return dict(window=np.flatnonzero((w32 >= F32(SATURATION_NM[0]))
                                      & (w32 <= F32(SATURATION_NM[1]))),
                cloud=[nearest(nm) for nm in CLOUD_NM], specular=nearest(SPECULAR_NM),
                dark=nearest(DARK_NM))


def pixel_tests(x, wavelengths, b):
    """(saturated, cloud, specular, dark, glint) of a (rows, cols, bands)
    float32 block of every band."""
    x = np.asarray(x, F32)
    w32 = np.asarray(wavelengths, np.float64).astype(F32)
    saturated = (x[..., b["window"]] > F32(SATURATION)).any(axis=-1)
    c0, c1, c2 = b["cloud"]
    with np.errstate(over="ignore"):
        slope_a = (x[..., c1] - x[..., c0]) / (w32[c1] - w32[c0])
        slope_b = (x[..., c2] - x[..., c1]) / (w32[c2] - w32[c1])
    cloud = (x[..., c0] > F32(CLOUD)) & (slope_a < 0) & (slope_b < 0)
    vis = x[..., b["specular"]]
    specular = saturated & (vis > F32(SPECULAR))
    dark = (x[..., b["dark"]] < F32(DARK)) & (x[..., b["dark"]] > F32(NODATA))
    return saturated, cloud, specular, dark, vis >= F32(SPECULAR)


def flare_block(saturated, specular, glint, grow_px, mingrowarea):
    """The flare band of one block, and whether any region seeded growth."""
    lab, n = ndimage.label(saturated, structure=np.ones((3, 3), bool))
    big = np.bincount(lab.ravel(), minlength=n + 1) >= mingrowarea
    big[0] = False
    seeds = big[lab] & ~glint
    out = np.zeros(saturated.shape, np.int16)
    if seeds.any():
        out[ndimage.distance_transform_edt(~seeds) <= grow_px] = 2
    out[saturated & ~specular] = 1
    return out, bool(seeds.any())


def buffer(mask, radius):
    """``mask`` grown by ``radius`` pixels in the taxicab metric."""
    if not radius or not mask.any():
        return mask
    return ndimage.distance_transform_cdt(~mask, metric="taxicab") <= math.ceil(radius)


def flightline_masks(read, nrows, ncols, wavelengths, *, grow_px, cldbfr_px, mingrowarea,
                     block_step):
    """The 4-band mask of a flightline. ``read(r0, r1, idx)`` returns lines
    [r0, r1) of bands ``idx`` as (rows, cols, len(idx)) float32. Returns
    (mask, blocks grown: the indices of the blocks whose flare growth had
    a seed)."""
    b = bands(wavelengths)
    idx = sorted({0, b["specular"], b["dark"], *b["cloud"], *b["window"].tolist()})
    pos = {k: i for i, k in enumerate(idx)}
    local = dict(window=np.array([pos[k] for k in b["window"]], np.int64),
                 cloud=[pos[k] for k in b["cloud"]], specular=pos[b["specular"]],
                 dark=pos[b["dark"]])
    wl = np.asarray(wavelengths, np.float64)[idx]
    overlap = math.ceil(mingrowarea + grow_px)
    flare = np.zeros((nrows, ncols), np.int16)
    tests = np.zeros((nrows, ncols, 3), bool)   # cloud, specular, dark
    nodata = np.zeros((nrows, ncols), bool)
    grown = []
    for k, r0 in enumerate(range(0, nrows, block_step)):
        r1 = min(nrows, r0 + block_step + overlap)
        x = read(r0, r1, idx)
        sat, cloud, spec, dark, glint = pixel_tests(x, wl, local)
        fl, seeded = flare_block(sat, spec, glint, grow_px, mingrowarea)
        if seeded:
            grown.append(k)
        flare[r0:r1] = np.maximum(flare[r0:r1], fl)
        tests[r0:r1] |= np.stack([cloud, spec, dark], axis=-1)
        nodata[r0:r1] = x[..., pos[0]] == F32(NODATA)
    out = np.stack([buffer(tests[..., 0], cldbfr_px), tests[..., 1], flare, tests[..., 2]],
                   axis=-1).astype(np.int16)
    out[nodata] = -9999
    return out, grown
