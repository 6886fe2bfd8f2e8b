"""CLI: one flightline through the port in one command.

    python -m srcfinder_torch.flow.pipeline_cli RADIANCE --library LIB \\
        --weights W.npz -o OUT [--masks] [--ime] [--method auto|shift|phase|dilated]
        [--fcn-dtype float32|bfloat16] [--device cuda|cpu]

runs radiance -> CMF [+ spectrometer masks] -> FCN saliency -> plume
candidates (xlsx+csv) [-> IME stats], with per-stage idempotent skips
(existing outputs are reused — the reference's resume convention) and
per-stage wall-clock timers. When both the CMF and the masks are to be
made, one streaming read of the radiance feeds both (the masks' line
blocks also fill the CMF's active-band and RGB slabs). Products are
written as ``<name>.part`` and renamed when complete, so a stage killed
mid-write never leaves a final-named partial product for the next run to
trust.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..cmf.pipeline import active_range_for_library, robust_mf_image
from ..core import envi as envi_io
from ..core.geo import mapinfo
from ..detect.fcn_pipeline import fcn_saliency_image, load_saliency_model
from ..detect.salience import salience2detections, save_detections
from ..device import resolve_device
from ..masks.cli import flightline_mask_config, mask_output_name, masks_for_flightline
from .ime_worker import compute_ime_for_cmf

__all__ = ["run_flightline", "main"]


def _finalize(*pairs):
    """Atomically promote ``<file>.part`` products to their final names
    (img + .hdr)."""
    for part, final in pairs:
        for ext in ("", ".hdr"):
            if os.path.exists(part + ext):
                os.replace(part + ext, final + ext)


class _Stage:
    """Wall-clock timer of one stage, recorded into ``timers[name]``."""

    def __init__(self, name, timers, progress):
        self.name, self.timers, self.progress = name, timers, progress

    def __enter__(self):
        self.t0 = time.time()
        self.progress(f"[STAGE] {self.name}")
        return self

    def __exit__(self, *exc):
        self.timers[self.name] = time.time() - self.t0
        self.progress(f"[STAGE] {self.name} done in "
                      f"{self.timers[self.name]:.1f}s")


def _masks_config_ok(radiance, progress) -> bool:
    """The masks' metadata check, made before any device work: without a
    wavelength list or a meter map info the masks (a skippable QC product)
    are skipped with a warning. Errors raised later, on the device
    included, propagate."""
    try:
        flightline_mask_config(envi_io.open_envi(radiance), radiance)
    except (ValueError, RuntimeError) as e:
        progress(f"[WARN] masks skipped: {e}")
        return False
    return True


def run_flightline(radiance: str, library: str, weights: str, outdir: str,
                   model_name: str = "multi_64", prob_thr: float = 0.5,
                   ppmm_thr: float = 250.0, method: str = "auto",
                   do_ime: bool = False, do_masks: bool = False,
                   dtype="float32", fcn_dtype="float32", bgmodes: int = 1,
                   col_chunk: int = 256, progress=print, device="cuda"):
    """Run all stages for one flightline; returns a dict of products
    (paths) plus ``timers`` (seconds per stage; the fused stage's two
    phases also as "read+masks" and "cmf phase") and, after a fused
    stage, "read+masks parts" (seconds of the disk reads, the slab taps,
    the pixel tests, the host growth and the block waits; the reads and
    taps run in a reader thread beside the rest).

    ``dtype``: the CMF's precision; ``fcn_dtype``: the FCN trunk's
    ("float32" or "bfloat16"). ``bgmodes``: the CMF's background modes
    per column (1: unimodal). ``device``: "cuda" (default; raises
    without a card) or "cpu".
    """
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(radiance))[0]
    lid = stem.split("_")[0]
    products: dict = {}
    timers: dict = {}

    # ---- L2 + L2b: CMF and spectrometer masks ----------------------------
    cmff = os.path.join(outdir, stem.replace("_rdn", "_cmf")
                        if "_rdn" in stem else stem + "_cmf")
    products["cmf"] = cmff
    need_cmf = not os.path.exists(cmff)
    if not need_cmf:
        progress(f"[SKIP] CMF exists: {cmff}")
    need_masks = False
    if do_masks:
        mskname = mask_output_name(stem)
        mskf = os.path.join(outdir, mskname)
        products["masks"] = mskf
        if os.path.exists(mskf):
            progress(f"[SKIP] masks exist: {mskf}")
        elif _masks_config_ok(radiance, progress):
            need_masks = True
        else:
            products["masks"] = None

    if need_cmf and need_masks:
        with _Stage("cmf+masks (fused single-pass read)", timers, progress):
            rdn = envi_io.open_envi(radiance)
            a0, a1 = active_range_for_library(library)
            a0 -= 1
            rgb_bands = (60, 42, 24)
            slab = np.empty((rdn.nrows, rdn.ncols, a1 - a0), np.float32)
            rgb = np.empty((rdn.nrows, rdn.ncols, 3), np.float32)

            def tap(r0, r1, blk, pos):
                # the active range is a contiguous run of the union band
                # list, so its positions are consecutive
                p0 = pos[a0]
                slab[r0:r1] = blk[:, :, p0:p0 + (a1 - a0)]
                rgb[r0:r1] = blk[:, :, [pos[b] for b in rgb_bands]]

            t0 = time.time()
            products["read+masks parts"] = parts = {}
            masks_for_flightline(radiance, outdir, out_name=mskname + ".part",
                                 device=dev, tap=tap,
                                 tap_bands=list(range(a0, a1)) + list(rgb_bands),
                                 timers=parts)
            timers["read+masks"] = time.time() - t0
            progress(f"[PHASE] read+masks done in {timers['read+masks']:.1f}s")
            t0 = time.time()
            robust_mf_image(radiance, library, cmff + ".part", bgmodes=bgmodes,
                            dtype=np.dtype(dtype).type, col_chunk=col_chunk,
                            rgb_bands=rgb_bands, preloaded=(slab, rgb), device=dev)
            timers["cmf phase"] = time.time() - t0
            progress(f"[PHASE] cmf done in {timers['cmf phase']:.1f}s")
            _finalize((mskf + ".part", mskf), (cmff + ".part", cmff))
    else:
        if need_cmf:
            with _Stage("cmf", timers, progress):
                robust_mf_image(radiance, library, cmff + ".part", bgmodes=bgmodes,
                                dtype=np.dtype(dtype).type, col_chunk=col_chunk,
                                device=dev)
                _finalize((cmff + ".part", cmff))
        if need_masks:
            with _Stage("masks", timers, progress):
                masks_for_flightline(radiance, outdir, out_name=mskname + ".part",
                                     device=dev)
                _finalize((mskf + ".part", mskf))

    # ---- L3: FCN saliency ------------------------------------------------
    salf = os.path.join(outdir, os.path.basename(cmff) + "_saliency")
    products["saliency"] = salf
    if os.path.exists(salf):
        progress(f"[SKIP] saliency exists: {salf}")
    else:
        with _Stage("fcn", timers, progress):
            img = envi_io.open_envi(cmff)
            band = np.asarray(img.read_band(-1), dtype=np.float32)
            model = load_saliency_model(weights, dtype=getattr(torch, fcn_dtype),
                                        device=dev)
            sal = fcn_saliency_image(band, model, model_name=model_name,
                                     method=method, device=dev)
            meta = {"data ignore value": -9999}
            if "map info" in img.metadata:
                meta["map info"] = img.metadata["map info"]
            envi_io.save_envi(salf + ".part.hdr", sal.cpu().numpy(),
                              metadata=meta, interleave="bip")
            _finalize((salf + ".part", salf))

    # ---- L4: candidates --------------------------------------------------
    detdir = os.path.join(outdir, os.path.basename(cmff) + "_detections")
    detname = "_".join([os.path.basename(cmff), "v2",
                        f"minsal{prob_thr:.2f}",
                        f"minppmm{ppmm_thr:.1f}"]).replace(".", "p")
    xlsxf = os.path.join(detdir, detname + ".xlsx")
    csvf = os.path.splitext(xlsxf)[0] + ".csv"
    products["detections_xlsx"] = xlsxf
    products["detections_csv"] = csvf
    if os.path.exists(csvf):
        progress(f"[SKIP] detections exist: {csvf}")
    else:
        with _Stage("salience", timers, progress):
            os.makedirs(detdir, exist_ok=True)
            cmfimg = envi_io.open_envi(cmff)
            salmm = envi_io.open_envi(salf).load().squeeze()
            detdf = salience2detections(salmm, cmfimg.load(), prob_thr,
                                        ppmm_thr, lid, mapinfo(cmfimg))
            if len(detdf):
                save_detections(xlsxf, detdf)
            else:
                progress("[INFO] no detections above thresholds")
                products["detections_xlsx"] = None
                products["detections_csv"] = None

    # ---- L5: IME ---------------------------------------------------------
    if do_ime:
        imef = os.path.join(outdir, os.path.basename(cmff) + "_ime.csv")
        products["ime_csv"] = imef
        if os.path.exists(imef):
            progress(f"[SKIP] IME exists: {imef}")
        else:
            with _Stage("ime", timers, progress):
                compute_ime_for_cmf(cmff, out_csv=imef)

    products["timers"] = timers
    return products


def build_parser():
    p = argparse.ArgumentParser(
        description="srcfinder (PyTorch/CUDA): radiance -> CMF [+ masks] -> "
                    "saliency -> plume list [-> IME] in one command")
    p.add_argument("radiance", help="radiance flightline (ENVI)")
    p.add_argument("--library", required=True,
                   help="unit-absorption library (name selects the gas "
                        "window, e.g. *ch4*.txt)")
    p.add_argument("--weights", required=True,
                   help="FCN weights (.npz in the Flax layout, or .pt)")
    p.add_argument("--outdir", "-o", default=".")
    p.add_argument("--model", default="multi_64")
    p.add_argument("--bgmodes", "-k", type=int, default=1,
                   help="CMF background modes per column (k-means)")
    p.add_argument("--prob_thr", type=float, default=0.5)
    p.add_argument("--ppmm_thr", type=float, default=250.0)
    p.add_argument("--method", default="auto",
                   choices=["auto", "shift", "phase", "dilated"],
                   help="FCN path (auto: phase, line-blocked for long scenes; "
                        "dilated is refused past a 2.5 Mpx canvas, 3,647 "
                        "lines at width 598)")
    p.add_argument("--ime", action="store_true")
    p.add_argument("--masks", action="store_true",
                   help="also make the 4-band spectrometer QC mask (needs "
                        "wavelengths in the radiance header); with the CMF "
                        "it shares one read of the cube")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"], help="CMF precision")
    p.add_argument("--fcn-dtype", default="float32",
                   choices=["float32", "bfloat16"], help="FCN trunk dtype")
    p.add_argument("--col_chunk", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (cuda raises without a card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    products = run_flightline(
        args.radiance, library=args.library, weights=args.weights,
        outdir=args.outdir, model_name=args.model, prob_thr=args.prob_thr,
        ppmm_thr=args.ppmm_thr, method=args.method, do_ime=args.ime,
        do_masks=args.masks, dtype=args.dtype, fcn_dtype=args.fcn_dtype,
        bgmodes=args.bgmodes,
        col_chunk=args.col_chunk, device=args.device)
    for k, v in products.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
