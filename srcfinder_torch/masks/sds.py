"""Spectrometer QC masks: cloud / specular / flare / dark.

Port of the JAX package's ``masks/sds.py`` (reference:
spectrometer_masks/masks_sds.py): the flightline streams in line blocks
with an overlap; the four per-pixel spectral tests of a block run on the
device as plain tensor ops (:func:`pixel_masks`); the flare-region growth
and the cloud buffer (labeling and dilation) stay on the host in
numpy/scipy. Output: a 4-band int16 mask with the radiance's nodata
pixels stamped -9999.

Behaviour kept from the JAX package:
- the reference's cloud test calls ``np.logical_and(a, b, c)`` with three
  masks (masks_sds.py:231), so numpy writes into the third and the second
  slope test is never applied; this applies the documented intent (bright
  AND both slopes negative); ``two_slope=False`` gives the literal one;
- the reference grows the flare mask in a per-coordinate loop
  (masks_sds.py:316-332) whose net effect is one dilation of the
  veto-filtered large regions; that is what is computed.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from scipy import ndimage

from ..core.morphology import disk, imlabel
from ..core.prefetch import BlockPrefetcher
from ..device import resolve_device

__all__ = ["MaskParams", "pixel_masks", "grow_flare_mask", "dilate_mask",
           "masks_for_cube", "get_radius_in_pixels", "needed_bands"]

SAT_THRESH_DEFAULT = 6.0       # (reference: masks_sds.py:50)
SAT_THRESH_CLD = 15.0          # (reference: masks_sds.py:52)
DARK_THRESH_DEFAULT = 0.104    # (reference: masks_sds.py:54)
VIS_GROW_THRESH = 9.0          # (reference: masks_sds.py:102-103)


class MaskParams(NamedTuple):
    saturation_threshold: float = SAT_THRESH_DEFAULT
    saturation_window: tuple = (1945.0, 2485.0)
    cld_threshold: float = SAT_THRESH_CLD
    cld_bands: tuple = (15, 60, 175)   # 450/1250(+670) nm AVIRIS-NG bands
    dark_threshold: float = DARK_THRESH_DEFAULT
    dark_band: int = 352               # 2139 nm
    spec_band: int = 25
    vis_grow_threshold: float = VIS_GROW_THRESH
    two_slope: bool = True


def pixel_masks(block, wavelengths, params: MaskParams):
    """The per-pixel spectral tests of one (rows, cols, bands) float32
    block, on the block's device. Returns (saturated, cloud, spec, dark)
    boolean maps (reference: get_saturation_mask :133-150, get_cloud_mask
    :180-233, get_spec_mask :152-162, get_dark_mask :164-178).

    Every test is an f32 comparison of the JAX package's f32 expression,
    in its order: the thresholds are rounded to f32 first, and the slope
    test divides the f32 radiance difference by the f32 wavelength step,
    so a difference the division rounds to zero tests as the JAX package's.
    """
    f32 = block.dtype

    def thr(v):
        return torch.tensor(v, dtype=f32, device=block.device)

    lo, hi = params.saturation_window
    in_window = (wavelengths >= thr(lo)) & (wavelengths <= thr(hi))
    saturated = ((block > thr(params.saturation_threshold))
                 & in_window[None, None, :]).any(dim=-1)

    b0, b1, b2 = params.cld_bands
    rdn1, rdn2, rdn3 = block[..., b0], block[..., b1], block[..., b2]
    is_bright = rdn1 > thr(params.cld_threshold)
    # negative spectral slopes (wavelengths increase with band index)
    slope_a = (rdn2 - rdn1) / (wavelengths[b1] - wavelengths[b0]) < 0
    cloud = is_bright & slope_a
    if params.two_slope:
        cloud &= (rdn3 - rdn2) / (wavelengths[b2] - wavelengths[b1]) < 0

    spec = saturated & (block[..., params.spec_band] > thr(params.vis_grow_threshold))

    darkv = block[..., params.dark_band]
    dark = (darkv < thr(params.dark_threshold)) & ~(darkv <= thr(-9999.0))
    return saturated, cloud, spec, dark


def get_radius_in_pixels(value_str: str, metadata) -> float:
    """'150m' or '10px' -> pixels using the ENVI map-info resolution
    (reference: masks_sds.py:235-250)."""
    if value_str.endswith("px"):
        return float(np.ceil(float(value_str[:-2])))
    if value_str.endswith("m"):
        if "map info" not in metadata:
            raise RuntimeError("Image does not have resolution specified. "
                               "Try giving values in pixels.")
        if "meters" not in str(metadata["map info"][10]).lower():
            raise RuntimeError("Unknown unit for image resolution.")
        mx = float(metadata["map info"][5])
        my = float(metadata["map info"][6])
        if mx != my:
            mx = (mx + my) / 2.0
        return float(np.ceil(float(value_str[:-1]) / mx))
    raise RuntimeError("Unknown unit specified.")


def grow_flare_mask(saturated, spec, vis_veto, grow_radius_px: float,
                    mingrowarea) -> np.ndarray:
    """Flare band: 2 where the grown buffer of large saturated regions
    lands, 1 at saturated non-specular pixels (reference:
    masks_sds.py:313-332). ``vis_veto``: bool map where the 500 nm
    radiance is at least the growth threshold (sun glint, not grown)."""
    saturated = np.asarray(saturated, bool)
    out = np.zeros(saturated.shape, np.uint8)
    lab = imlabel(saturated)  # 2-connectivity
    if lab.max() > 0:
        sizes = np.bincount(lab.ravel())
        keep = sizes >= (mingrowarea if mingrowarea is not None else 0)
        keep[0] = False
        grow_seeds = keep[lab] & ~np.asarray(vis_veto, bool)
        if grow_seeds.any():
            selem = disk(int(grow_radius_px))
            grown = ndimage.binary_dilation(grow_seeds, structure=selem)
            out[grown] = 2
    out[saturated & ~np.asarray(spec, bool)] = 1
    return out


def dilate_mask(binmask, radius_px: float) -> np.ndarray:
    """Iterated 3x3-cross dilation, ceil(radius) times
    (reference: masks_sds.py:252-272)."""
    buf = np.asarray(binmask, bool)
    for _ in range(int(np.ceil(radius_px))):
        buf = ndimage.binary_dilation(buf)
    return buf


def needed_bands(wavelengths, params: MaskParams):
    """Bands the mask tests read: the saturation window plus the cloud,
    specular and dark bands (~80 of 425 on AVIRIS-NG); only these are
    read and sent to the device."""
    wl = np.asarray(wavelengths)
    lo, hi = params.saturation_window
    need = set(np.where((wl >= lo) & (wl <= hi))[0].tolist())
    need.update(int(b) for b in params.cld_bands)
    need.add(int(params.spec_band))
    need.add(int(params.dark_band))
    return np.array(sorted(need), dtype=np.int64)


def _compact_params(params: MaskParams, need) -> MaskParams:
    """Remap band indices into the compacted band axis."""
    pos = {int(b): i for i, b in enumerate(need)}
    return params._replace(
        cld_bands=tuple(pos[int(b)] for b in params.cld_bands),
        spec_band=pos[int(params.spec_band)],
        dark_band=pos[int(params.dark_band)])


def masks_for_cube(read_block=None, nrows: int = None, ncols: int = None,
                   wavelengths=None, params: MaskParams = MaskParams(),
                   maskgrowradius_px: float = None, mingrowarea=None,
                   cldbfr_px: float = 0.0, block_step: int = 500,
                   nodata_row0=None, read_block_bands=None, device="cuda",
                   timers=None):
    """Stream a flightline in line blocks and assemble the 4-band mask
    (reference: masks_sds.py:284-348). Returns (rows, cols, 4) int16:
    [cloud (buffered), specular, flare, dark].

    ``read_block(r0, r1)`` -> (rows, cols, bands) float block of all
    bands (the needed subset is sliced here), or
    ``read_block_bands(r0, r1, bands)`` -> (rows, cols, len(bands)),
    which reads only the needed bands. Blocks are read one ahead in a
    background thread (:class:`BlockPrefetcher`) while the current one is
    tested on ``device``; the last block is padded with -9999 rows, which
    trip no test. ``nodata_row0``: a bool map, or a callable evaluated
    after the streaming loop, of the pixels stamped -9999.
    ``device``: "cuda" (default; raises without a card) or "cpu".
    ``timers``: optional dict that receives the seconds of the pixel tests
    (to their maps on the host), of the host growth and buffer, and of
    the waits for the next block ("pixel tests", "growth", "wait").
    """
    dev = resolve_device(device)
    clock = {"pixel tests": 0.0, "growth": 0.0, "wait": 0.0}
    wl_full = np.asarray(wavelengths, np.float32)
    need = needed_bands(wl_full, params)
    params = _compact_params(params, need)
    wl = torch.as_tensor(wl_full[need], device=dev)
    sat_full = np.zeros((nrows, ncols), np.uint8)
    cloud_full = np.zeros((nrows, ncols), np.uint8)
    spec_full = np.zeros((nrows, ncols), np.uint8)
    dark_full = np.zeros((nrows, ncols), np.uint8)
    flare_full = np.zeros((nrows, ncols), np.uint8)

    overlap = int(np.ceil((mingrowarea or 0) + (maskgrowradius_px or 0)))
    block_length = block_step + overlap
    starts = list(range(0, nrows, block_step))
    vetoes: dict = {}

    def _read(bi):
        r0 = starts[bi]
        r1 = min(nrows, r0 + block_length)
        if read_block_bands is not None:
            blk = np.asarray(read_block_bands(r0, r1, need), np.float32)
        else:
            blk = np.asarray(read_block(r0, r1), np.float32)[:, :, need]
        if blk.shape[0] < block_length:
            blk = np.concatenate(
                [blk, np.full((block_length - blk.shape[0],) + blk.shape[1:],
                              -9999.0, np.float32)], axis=0)
        # the flare growth's veto map is a host input: taken here, before
        # the block goes to the device
        vetoes[bi] = blk[: r1 - r0, :, params.spec_band] >= np.float32(
            params.vis_grow_threshold)
        return blk

    t_wait = time.perf_counter()
    for bi, blk in BlockPrefetcher(_read, len(starts), device=dev):
        t_tests = time.perf_counter()
        clock["wait"] += t_tests - t_wait
        vis_veto = vetoes.pop(bi)
        r0 = starts[bi]
        r1 = min(nrows, r0 + block_length)
        sat, cloud, spec, dark = (m[: r1 - r0].cpu().numpy()
                                  for m in pixel_masks(blk, wl, params))
        t_grow = time.perf_counter()
        clock["pixel tests"] += t_grow - t_tests
        spec_full[r0:r1][spec] = 1
        cloud_full[r0:r1][cloud] = 1
        dark_full[r0:r1][dark] = 1
        sat_full[r0:r1][sat] = 1
        if maskgrowradius_px is not None:
            fl = grow_flare_mask(sat, spec, vis_veto, maskgrowradius_px, mingrowarea)
            flare_full[r0:r1] = np.maximum(flare_full[r0:r1], fl)
        t_wait = time.perf_counter()
        clock["growth"] += t_wait - t_grow

    cloud_buf = (dilate_mask(cloud_full, cldbfr_px) if cldbfr_px
                 else cloud_full.astype(bool))
    clock["growth"] += time.perf_counter() - t_wait
    if timers is not None:
        timers.update(clock)

    out = np.zeros((nrows, ncols, 4), np.int16)
    out[..., 0] = cloud_buf
    out[..., 1] = spec_full
    out[..., 2] = flare_full
    out[..., 3] = dark_full
    if callable(nodata_row0):
        nodata_row0 = nodata_row0()
    if nodata_row0 is not None:
        out[np.asarray(nodata_row0)] = -9999
    return out
