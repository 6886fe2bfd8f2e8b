"""CMF column-profile statistics and systematics detection.

Port of the JAX package's ``triage/profile.py`` (reference:
triage/cmf_profile.py): per detector column of the CMF band,
npix/avg/std/min/max (or robust npix/med/mad/p05/p95) over valid positive
pixels, saved as ``*_column_stats.csv``. The systematics detector
(``systematics_count``, ``flag_systematics``) is host numpy in
:mod:`.systematics`, re-exported here as the JAX package's module has it.

The column reductions run as torch on the device; files are profiled in
a thread pool (the reference uses a dask LocalCluster,
cmf_profile.py:239-248), each file one read and one device call.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import torch

from ..core import envi as envi_io
from ..device import resolve_device
# the detector is host numpy and lives where torch is not imported
from .systematics import flag_systematics, systematics_count

__all__ = ["column_stats", "summarize_cmf", "plot_stats", "systematics_count",
           "flag_systematics", "profile_files", "ANG_NCOLS"]

#: AVIRIS-NG FPA columns (reference: COVID_systematics_ID_Deliver.py:36)
ANG_NCOLS = 598


def _nanquantile(x, q):
    """Per-column quantiles of x (L, C) over its non-NaN values with linear
    interpolation (numpy's default method, as ``jnp.nanpercentile``);
    NaN where a column has none. q: a float or a 1-D tensor."""
    return torch.nanquantile(x, torch.as_tensor(q, dtype=x.dtype, device=x.device),
                             dim=0, interpolation="linear")


def column_stats(cmf, mask, robust: bool = False):
    """Per-column stats over masked pixels, on the tensors' device.
    cmf: (L, C) float, mask: (L, C) bool.

    standard: npix/avg/std/min/max (reference: cmf_profile.py:128-132;
              std with ddof 0)
    robust:   npix/med/mad/p05/p95 (reference: cmf_profile.py:124-127;
              mad is the median absolute deviation, unscaled)
    Statistics of a column with no masked pixel are NaN.
    """
    nan = torch.full((), float("nan"), dtype=cmf.dtype, device=cmf.device)
    x = torch.where(mask, cmf, nan)
    npix = mask.sum(dim=0).to(torch.int32)
    if robust:
        med = _nanquantile(x, 0.5)
        madv = _nanquantile(torch.abs(x - med[None, :]), 0.5)
        lo, hi = _nanquantile(x, [0.05, 0.95])
        return npix, med, madv, lo, hi
    avg = torch.nanmean(x, dim=0)
    std = torch.sqrt(torch.nanmean((x - avg[None, :]) ** 2, dim=0))
    none = npix == 0
    mn = torch.where(none, nan, torch.where(mask, cmf, torch.inf).amin(dim=0))
    mx = torch.where(none, nan, torch.where(mask, cmf, -torch.inf).amax(dim=0))
    return npix, avg, std, mn, mx


def summarize_cmf(cmff: str, outdir: str = ".", use_robust_stats=False,
                  overwrite=False, device="cuda"):
    """One CMF file -> column-stats CSV (reference: cmf_profile.py:90-140).
    Returns the csv path, or False if it exists and ``overwrite`` is off.
    ``device``: "cuda" (default; raises without a card) or "cpu"."""
    dev = resolve_device(device)
    outbase = os.path.splitext(os.path.basename(cmff))[0]
    os.makedirs(outdir or ".", exist_ok=True)
    colcsv = os.path.join(outdir, outbase + "_column_stats.csv")
    if os.path.exists(colcsv) and not overwrite:
        return False

    # the CMF band's valid positive pixels (reference: cmf_profile.py:110-118)
    img = envi_io.open_envi(cmff)
    cmf = np.asarray(img.read_band(-1), np.float32)
    nodatav = np.float32(img.metadata.get("data ignore value", -9999))
    cmfmask = ~((cmf == nodatav) | np.isnan(cmf)) & (cmf > 0)
    stats = column_stats(torch.from_numpy(cmf).to(dev), torch.from_numpy(cmfmask).to(dev),
                         robust=bool(use_robust_stats))
    statcols = (["npix", "med", "mad", "p05", "p95"] if use_robust_stats
                else ["npix", "avg", "std", "min", "max"])
    coldf = pd.DataFrame(np.c_[tuple(s.cpu().numpy() for s in stats)], columns=statcols)
    coldf.to_csv(colcsv, index=False)
    return colcsv


def plot_stats(cmff: str, colcsv: str, use_robust_stats=False,
               ncols_fpa: int = ANG_NCOLS):
    """Quicklook PDFs for one profiled CMF (reference:
    cmf_profile.py:144-212): (1) CMF overlay + column mu±sigma profile +
    valid-pixel percentage; (2) rolling-median(3) deviation with 1/2/3
    sigma(MAD) detection lines. Returns the two pdf paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..core.stats import mad as _mad

    df = pd.read_csv(colcsv)
    avg = df["med"] if use_robust_stats else df["avg"]
    std = df["mad"] if use_robust_stats else df["std"]
    colidx = np.arange(len(df))

    img = envi_io.open_envi(cmff)
    cube = img.load()
    rgb = np.clip(np.asarray(cube[..., :-1], np.float32) / 15, 0, 1)
    cmf = np.asarray(cube[..., -1], np.float32)
    nodatav = np.float32(img.metadata.get("data ignore value", -9999))
    cmfm = np.where((cmf == nodatav) | (cmf <= 0), np.nan, cmf)

    maxidx = int(np.nanargmax(avg.values))
    colfigf = os.path.splitext(colcsv)[0] + ".pdf"
    fig, ax = plt.subplots(3, 1, figsize=(24, 3 * 3.25))
    ax[0].imshow(rgb.transpose(1, 0, 2))
    ax[0].imshow(cmfm.T, vmin=500, vmax=1500, cmap="YlOrRd",
                 interpolation="none")
    ax[0].set_ylabel("CMF column", size="small")
    ax[0].axhline(maxidx, c="m", ls="--")
    ax[1].set_title(os.path.basename(os.path.splitext(cmff)[0]))
    ax[1].plot(colidx, avg, c="b")
    ax[1].plot(colidx, avg - std, c="b", ls="--", alpha=0.5)
    ax[1].plot(colidx, avg + std, c="b", ls="--", alpha=0.5)
    ax[1].set_ylabel("CMF $\\mu \\pm \\sigma$ (ppmm)")
    ax[2].plot(colidx, 100 * df["npix"].values / max(rgb.shape[0], 1))
    ax[2].set_ylim(0.0, 100.0)
    ax[2].set_ylabel("Valid pixels (%)")
    ax[2].set_xlabel("CMF column")
    for axi in (ax[1], ax[2]):
        axi.set_xlim(0, ncols_fpa)
        axi.axvline(maxidx, c="m", ls="--", alpha=0.8)
    fig.tight_layout()
    fig.savefig(colfigf)
    plt.close(fig)

    # rolling-median deviation detector plot
    colrwinf = os.path.splitext(colcsv)[0] + "_rwin.pdf"
    ser = pd.Series(avg.values)
    rwin = ser.rolling(3, center=True).median()
    rwin.iloc[0] = np.nanmedian(ser.values[:3])
    rwin.iloc[-1] = np.nanmedian(ser.values[-3:])
    coldiff = ser - rwin
    colsigma = _mad(ser.values[np.isfinite(ser.values)])
    fig, ax = plt.subplots(2, 1, figsize=(25, 6.75), sharex=True)
    ax[0].plot(ser)
    ax[0].plot(rwin)
    ax[1].plot(coldiff)
    for i, c in enumerate(("yellow", "orange", "red")):
        ax[1].axhline((i + 1) * colsigma, c=c)
    ax[0].set_xlim(0, ncols_fpa)
    fig.tight_layout()
    fig.savefig(colrwinf)
    plt.close(fig)
    return colfigf, colrwinf


def profile_files(cmffiles, outdir=".", use_robust_stats=False, n_jobs=1,
                  overwrite=False, device="cuda"):
    """Profile many CMF files (the reference parallelizes with a dask
    LocalCluster, one file per worker; here a thread pool)."""
    def one(f):
        return summarize_cmf(f, outdir, use_robust_stats, overwrite, device=device)
    if n_jobs <= 1 or len(cmffiles) == 1:
        return [one(f) for f in cmffiles]
    with ThreadPoolExecutor(max_workers=n_jobs) as ex:
        return list(ex.map(one, cmffiles))
