"""CMF image pipeline: ENVI in -> matched filter on the device -> ENVI out.

Port of the JAX package's ``cmf/pipeline.py``, unimodal and multimodal
(``bgmodes > 1``). Mirrors the reference script's I/O contract
(reference: cmf/robust_mf.py __main__, :139-405): 4-band BIP float64
output (RGB radiance + CH4 ppm*m), nodata-stamped MF band, per-column
stats CSV, optional bgmeta image with cluster id and alpha index. The
active-band window is read once and moved to the device whole; columns
are processed there in fixed-shape chunks of ``col_chunk`` (the last
chunk padded with zero columns).

The JAX package's backend routing and compile warm-up
(``_route_backend``, ``warm_tpu_async``) are not carried: they route the
CMF to the host by the TPU link's measured bandwidth and stage the TPU's
compile, and nothing on a card corresponds.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from ..core import envi as envi_io
from ..device import resolve_device
from . import matched_filter as mfmod

__all__ = ["active_range_for_library", "load_library", "robust_mf_image"]

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def active_range_for_library(library_path: str, reflectance: bool = False):
    """Active channel window from the library filename
    (reference: robust_mf.py:185-194)."""
    name = os.path.basename(library_path)
    if reflectance and "ch4" in name:
        return (5, 420)
    if "ch4" in name:
        return (351, 422)
    if "co2" in name:
        return (309, 391)
    raise ValueError(f"could not set active range for library {library_path}")


def load_library(library_path: str, active):
    """Unit-absorption spectrum, column 3 over the active window
    (reference: robust_mf.py:237-238)."""
    libdata = np.loadtxt(library_path).astype(np.float64)
    return libdata[active[0] - 1: active[1], 2]


_BAND_NAMES_4 = ["Red Radiance (uW/nm/sr/cm2)",
                 "Green Radiance (uW/nm/sr/cm2)",
                 "Blue Radiance (uW/nm/sr/cm2)",
                 "CH4 Absorption (ppm x m)"]


def _f64_columns(xblk, cols, abscf, alphas, model, reflectance):
    """Recompute the columns ``cols`` of a device chunk in float64 on the
    same device (the reference's native precision). Columns are
    independent, so no padding is needed."""
    sub = xblk[:, torch.as_tensor(cols, device=xblk.device), :].to(torch.float64)
    m = mfmod.valid_mask(sub).to(torch.float64)
    res = mfmod.matched_filter_columns(
        sub, m, torch.as_tensor(abscf, dtype=torch.float64, device=sub.device),
        torch.as_tensor(alphas, dtype=torch.float64, device=sub.device),
        model=model, reflectance=reflectance)
    return res.mf.cpu().numpy(), res.alpha_index.cpu().numpy()


def _f64_columns_multimodal(xblk, cols, abscf, alphas, model, reflectance,
                            bgmodes, pcadim, reject, regfull):
    """Recompute the columns ``cols`` of a device chunk through the whole
    multimodal path (PCA, k-means, per-mode fits) in float64 on the same
    device: the f64 answer for those columns, not f32 labels with f64
    fits. Returns mf, valid, labels, alpha_pix as numpy (L, len(cols))."""
    sub = xblk[:, torch.as_tensor(cols, device=xblk.device), :].to(torch.float64)
    m = mfmod.valid_mask(sub).to(torch.float64)
    res = mfmod.matched_filter_columns_multimodal(
        sub, m, torch.as_tensor(abscf, dtype=torch.float64, device=sub.device),
        torch.as_tensor(alphas, dtype=torch.float64, device=sub.device),
        bgmodes=bgmodes, pcadim=pcadim, reject=reject, regfull=regfull,
        model=model, reflectance=reflectance)
    return tuple(t.cpu().numpy() for t in (res.mf, res.valid, res.labels, res.alpha_pix))


def robust_mf_image(infile: str, library: str, outfile: str,
                    model: str = "looshrinkage", bgmodes: int = 1,
                    pcadim: int = 6, reject: bool = False,
                    regfull: bool = False,
                    reflectance: bool = False, rgb_bands=(60, 42, 24),
                    save_bgmeta: bool = False, col_chunk: int = 256,
                    dtype=np.float32, verbose: bool = False,
                    cond_thresh: float = 1e-6, preloaded=None,
                    device="cuda"):
    """Run the columnwise robust MF over a full flightline.

    Returns a dict with output paths and the column-stats arrays.

    ``bgmodes``: background modes per column (1: unimodal; more: PCA to
    ``pcadim`` dims, k-means, one fit per mode, see
    :func:`.matched_filter.matched_filter_columns_multimodal` for
    ``reject`` and ``regfull``).
    ``dtype``: float32 (default) or float64 compute precision.
    ``cond_thresh``: in the float32 path, columns whose whitened
    covariance has ``lam_min/lam_max`` below this (the near-singular
    regime where f32 cannot track f64) are recomputed in float64 on the
    same device and overwritten. 0 disables. With ``bgmodes > 1`` the
    gate is per (column, mode): a column with any ill-conditioned mode in
    use is recomputed through the whole multimodal path in float64.
    ``preloaded``: optional ``(active_slab, rgb_slab)`` already in RAM —
    ``active_slab`` (lines, samples, active_bands) and ``rgb_slab``
    (lines, samples, 3); skips every disk read of the cube.
    ``device``: "cuda" (default; raises without a card) or "cpu".
    """
    dev = resolve_device(device)
    dt = _TORCH_DTYPE[np.dtype(dtype)]
    img = envi_io.open_envi(infile)
    nrows, ncols = img.nrows, img.ncols

    active = active_range_for_library(library, reflectance)
    abscf = load_library(library, active)
    alphas = mfmod.default_alphas()
    nodata = float(img.metadata.get("data ignore value", -9999))
    if nodata > 0:
        raise ValueError(f"nodata value={nodata} > 0, values will not be masked")

    rgb_bands = list(rgb_bands) if rgb_bands else []

    # ---- output metadata (reference: robust_mf.py:210-259) -----------
    outmeta = OrderedDict(img.metadata)
    outmeta["lines"] = nrows
    outmeta["samples"] = ncols
    outmeta["data type"] = envi_io.dtype_to_envi(np.float64)
    if len(rgb_bands) == 3:
        outmeta["bands"] = 4
        outmeta["band names"] = list(_BAND_NAMES_4)
    elif len(rgb_bands) == 0:
        outmeta["bands"] = 1
        outmeta["band names"] = [_BAND_NAMES_4[-1]]
    else:
        raise ValueError(f"invalid rgb_bands: {rgb_bands}")
    outmeta["interleave"] = "bip"
    for kwarg in ["smoothing factors", "wavelength", "wavelength units", "fwhm"]:
        outmeta.pop(kwarg, None)
    bgmodel = "unimodal" if bgmodes == 1 else "multimodal"
    parms = f"modelname={model}, bgmodel={bgmodel}"
    if bgmodes > 1:
        parms += f", bgmodes={bgmodes}, pcadim={pcadim}, reject={reject}"
        if model == "looshrinkage":
            parms += f", regfull={regfull}"
    if model == "looshrinkage":
        parms += ", aminexp=-10.0, amaxexp=0.0, astep=0.05"
    parms += f", reflectance={reflectance}, active_bands={list(active)}"
    outmeta["model parameters"] = "{ %s }" % parms

    outimg = envi_io.create_envi(outfile + ".hdr", outmeta, force=True, ext="")
    out_mm = outimg.open_memmap(interleave="source", writable=True)  # (L, C, bands)
    out_mm[:, :, -1] = nodata

    if save_bgmeta:
        bgmeta = OrderedDict(outmeta)
        bgmeta["bands"] = 2
        bgmeta["data type"] = envi_io.dtype_to_envi(np.int16)
        bgmeta["num alphas"] = len(alphas)
        bgmeta["band names"] = ["cluster_id", "alpha_index"]
        bgimg = envi_io.create_envi(outfile + "_bgmeta.hdr", bgmeta,
                                    force=True, ext="")
        bg_mm = bgimg.open_memmap(interleave="source", writable=True)

    colnum = np.full(ncols, nodata)
    colavg = np.full(ncols, nodata)
    colstd = np.full(ncols, nodata)

    ppm = 1.0 if reflectance else mfmod.PPM_SCALING

    # ---- the active-band window, read once, moved to the device whole
    if preloaded is not None:
        pre_active, pre_rgb = preloaded
        x_all = torch.from_numpy(np.asarray(pre_active)).to(dev)   # (L, C, AB)
    else:
        raw = img.read_band_window(active[0] - 1, active[1])      # (L, AB, C)
        x_all = torch.from_numpy(raw).to(dev).permute(0, 2, 1)    # (L, C, AB) view
        pre_rgb = None
        if rgb_bands:
            sel = sorted(set(int(b) for b in rgb_bands))
            win = img.read_lines_bands(0, nrows, sel)             # (L, C, n)
            pre_rgb = np.stack([win[:, :, sel.index(int(b))]
                                for b in rgb_bands], axis=-1)
    alphas_t = torch.as_tensor(alphas, dtype=dt, device=dev)
    abscf_t = torch.as_tensor(abscf, dtype=dt, device=dev)

    nblocks = -(-ncols // col_chunk)
    f64_columns = 0
    for bi in range(nblocks):
        c0 = bi * col_chunk
        c1 = min(ncols, c0 + col_chunk)
        width = c1 - c0
        xj = x_all[:, c0:c1, :].to(dt).contiguous()
        if width < col_chunk:  # fixed chunk shape; padded columns are dropped
            xj = torch.cat([xj, xj.new_zeros((nrows, col_chunk - width,
                                              xj.shape[2]))], dim=1)
        mj = mfmod.valid_mask(xj).to(dt)
        if bgmodes > 1:
            res = mfmod.matched_filter_columns_multimodal(
                xj, mj, abscf_t, alphas_t, bgmodes=bgmodes, pcadim=pcadim,
                reject=reject, regfull=regfull, model=model,
                reflectance=reflectance)
            mf = res.mf.cpu().numpy() * ppm
            valid = res.valid.cpu().numpy()
            labels = res.labels.cpu().numpy()
            alpha_pix = res.alpha_pix.cpu().numpy()
            if cond_thresh and dt == torch.float32:
                cond = res.cond[:width].cpu().numpy()           # (w, K)
                cnts = res.counts[:width].cpu().numpy()
                rejm = res.rejected[:width].cpu().numpy()
                # ~(cond >= thresh): a NaN cond must also be recomputed
                flagged = ~(cond >= cond_thresh) & (cnts >= 2) & ~rejm
                bad = np.nonzero(flagged.any(axis=1))[0]
                if bad.size:
                    if verbose:
                        print(f"[INFO] columns {c0 + bad} have modes with "
                              f"cond<{cond_thresh:g}: f64 multimodal "
                              f"recompute on {dev}")
                    mf64, v64, l64, a64 = _f64_columns_multimodal(
                        xj, bad, abscf, alphas, model, reflectance, bgmodes,
                        pcadim, reject, regfull)
                    mf[:, bad] = mf64 * ppm
                    valid[:, bad] = v64
                    labels[:, bad] = l64
                    alpha_pix[:, bad] = a64
                f64_columns += int(bad.size)
            if save_bgmeta:
                bg_mm[:, c0:c1, 0] = labels[:, :width]
                bg_mm[:, c0:c1, 1] = alpha_pix[:, :width]
        else:
            res = mfmod.matched_filter_columns(xj, mj, abscf_t, alphas_t,
                                               model=model,
                                               reflectance=reflectance)
            mf = res.mf.cpu().numpy() * ppm
            valid = mj.cpu().numpy() > 0
            alpha_index = res.alpha_index.cpu().numpy().copy()
            if cond_thresh and dt == torch.float32:
                cond = res.cond[:width].cpu().numpy()
                nvalid = res.n[:width].cpu().numpy()
                # ~(cond >= thresh), NOT (cond < thresh): a NaN cond (f32
                # eigh on a rank-deficient covariance) must also be
                # recomputed
                bad = np.nonzero(~(cond >= cond_thresh) & (nvalid >= 2))[0]
                if bad.size:
                    if verbose:
                        print(f"[INFO] columns {c0 + bad} cond<{cond_thresh:g}: "
                              f"f64 recompute on {dev}")
                    mf64, a64 = _f64_columns(xj, bad, abscf, alphas, model,
                                             reflectance)
                    mf[:, bad] = mf64 * ppm
                    alpha_index[bad] = a64
                f64_columns += int(bad.size)
            if save_bgmeta:
                bg_mm[:, c0:c1, 0] = 1
                bg_mm[:, c0:c1, 1] = alpha_index[None, :width]

        mf = mf[:, :width]
        valid = valid[:, :width]
        out_mm[:, c0:c1, -1] = np.where(valid, mf, nodata)
        if len(rgb_bands) == 3:
            out_mm[:, c0:c1, :3] = pre_rgb[:, c0:c1, :]

        nblk = valid.sum(axis=0)
        with np.errstate(invalid="ignore"):
            avg = np.where(nblk > 0, (mf * valid).sum(axis=0) / np.maximum(nblk, 1),
                           nodata)
            var = np.where(
                nblk > 0,
                (valid * (mf - avg[None, :]) ** 2).sum(axis=0) / np.maximum(nblk, 1),
                0.0)
        colnum[c0:c1] = np.where(nblk > 0, nblk, nodata)
        colavg[c0:c1] = avg
        colstd[c0:c1] = np.where(nblk > 0, np.sqrt(var), nodata)
        if verbose:
            print(f"columns [{c0}:{c1}] done")

    out_mm.flush()
    if save_bgmeta:
        bg_mm.flush()

    # ---- column stats CSV (reference: robust_mf.py:399-403; one row per
    # column with npix/avg/std columns) ----------------------------------
    colcsv = os.path.splitext(infile)[0] + "_column_stats.csv"
    import pandas as pd
    coldf = pd.DataFrame({"npix": colnum, "avg": colavg, "std": colstd})
    coldf.to_csv(colcsv, index_label="column")

    return dict(outfile=outfile, colcsv=colcsv,
                colnum=colnum, colavg=colavg, colstd=colstd,
                f64_columns=f64_columns)
