"""CLI: one flightline through the port in one command.

    python -m srcfinder_torch.flow.pipeline_cli RADIANCE --library LIB \\
        --weights W.npz -o OUT [--masks] [--ime] [--quicklooks]
        [--winds WINDS_DIR --wind-ext .grib2|.npz]
        [--method auto|shift|phase|dilated] [--fcn-dtype float32|bfloat16]
        [--device cuda|cpu]

runs radiance -> CMF [+ spectrometer masks] -> FCN saliency -> plume
candidates (xlsx+csv) [+ quicklook PDFs] [-> IME stats] [-> wind
statistics and emission rates], with per-stage idempotent skips
(existing outputs are reused — the reference's resume convention) and
per-stage wall-clock timers. When both the CMF and the masks are to be
made, one streaming read of the radiance feeds both (the masks' line
blocks also fill the CMF's active-band and RGB slabs). Products are
written as ``<name>.part`` and renamed when complete, so a stage killed
mid-write never leaves a final-named partial product for the next run to
trust.

``--watch DIR`` instead consumes new radiance files from a directory
(DirWatcher + JobQueue, the S3-event analog) and keeps going on
per-flightline failures; ``--once`` processes the backlog and exits, 1 if
a flightline failed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import pandas as pd
import torch

from ..cmf.pipeline import preload_slabs, robust_mf_image
from ..core import envi as envi_io
from ..core.geo import mapinfo
from ..detect.fcn_pipeline import fcn_saliency_image, load_saliency_model
from ..detect.salience import salience2detections, save_detections
from ..device import resolve_device
from ..masks.cli import flightline_mask_config, mask_output_name, masks_for_flightline
from ..trace import Stage, span, spans
from .deploy import JobQueue, watch_and_trigger
from .ime_worker import compute_ime_for_cmf, merge_ime_into_plumelist
from .msf_flow import insert_plumes_in_file, process_plumes

__all__ = ["run_flightline", "main"]


def _finalize(*pairs):
    """Atomically promote ``<file>.part`` products to their final names
    (img + .hdr)."""
    for part, final in pairs:
        for ext in ("", ".hdr"):
            if os.path.exists(part + ext):
                os.replace(part + ext, final + ext)


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
                   winds: str | None = None, wind_ext: str = ".grib2",
                   do_ime: bool = False, do_masks: bool = False,
                   quicklooks: bool = False,
                   dtype="float32", fcn_dtype="float32", bgmodes: int = 1,
                   col_chunk: int = 256, progress=print, device="cuda"):
    """Run all stages for one flightline; returns a dict of products
    (paths) plus ``timers`` and ``spans``.

    ``timers``: seconds of each stage run ("cmf", "masks", "fcn",
    "salience", "ime", "msf-flow"; the fused "cmf+masks (fused single-pass
    read)" and its two phases "read+masks" and "cmf phase"), each its
    stage span's duration; a stage on a card synchronises it before its
    clock stops. ``spans``: the flightline's :mod:`srcfinder_torch.trace`
    spans, in the order they closed: the root "run_flightline", a span per
    stage, and their children ("cmf.read", "cmf.h2d", a "cmf.chunk" and a
    "cmf.stats" per column chunk, "cmf.write", "fcn.read", "fcn.model",
    "fcn.forward", "fcn.write", "salience.read", "salience.detect",
    "salience.write", "ime.read", "ime.label", "ime.merge", "ime.write"),
    the "*.read" and "*.write" spans counting their ``bytes``.

    ``dtype``: the CMF's precision; ``fcn_dtype``: the FCN trunk's
    ("float32" or "bfloat16"). ``bgmodes``: the CMF's background modes
    per column (1: unimodal). ``winds``: a directory of wind grids
    (``hrrr*/`` and ``rtma*/`` subdirectories of ``wind_ext`` files), which
    turns on the emission stage: the plume list, with the IME columns when
    ``do_ime``, enriched with wind statistics and emission rates.
    ``quicklooks``: a PDF per candidate beside the plume list.
    ``device``: "cuda" (default; raises without a card) or "cpu"; the
    emission stage's nearest-cell search runs there too.
    """
    with span("run_flightline") as root:
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
            with Stage("cmf+masks (fused single-pass read)", timers, progress, dev):
                tap, tap_bands, preloaded = preload_slabs(radiance, library)
                with span("read+masks") as phase:
                    masks_for_flightline(radiance, outdir, out_name=mskname + ".part",
                                         device=dev, tap=tap, tap_bands=tap_bands)
                timers["read+masks"] = phase.seconds
                progress(f"[PHASE] read+masks done in {timers['read+masks']:.1f}s")
                with span("cmf phase") as phase:
                    robust_mf_image(radiance, library, cmff + ".part", bgmodes=bgmodes,
                                    dtype=np.dtype(dtype).type, col_chunk=col_chunk,
                                    preloaded=preloaded, device=dev)
                timers["cmf phase"] = phase.seconds
                progress(f"[PHASE] cmf done in {timers['cmf phase']:.1f}s")
                _finalize((mskf + ".part", mskf), (cmff + ".part", cmff))
        else:
            if need_cmf:
                with Stage("cmf", timers, progress, dev):
                    robust_mf_image(radiance, library, cmff + ".part", bgmodes=bgmodes,
                                    dtype=np.dtype(dtype).type, col_chunk=col_chunk,
                                    device=dev)
                    _finalize((cmff + ".part", cmff))
            if need_masks:
                with Stage("masks", timers, progress, dev):
                    masks_for_flightline(radiance, outdir, out_name=mskname + ".part",
                                         device=dev)
                    _finalize((mskf + ".part", mskf))

        # ---- L3: FCN saliency ------------------------------------------------
        salf = os.path.join(outdir, os.path.basename(cmff) + "_saliency")
        products["saliency"] = salf
        if os.path.exists(salf):
            progress(f"[SKIP] saliency exists: {salf}")
        else:
            with Stage("fcn", timers, progress, dev):
                with span("fcn.read") as s:
                    img = envi_io.open_envi(cmff)
                    # a BIP product is read whole for its last band
                    band = np.asarray(img.read_band(-1), dtype=np.float32)
                    s.count(bytes=os.path.getsize(cmff))
                with span("fcn.model"):
                    model = load_saliency_model(weights, dtype=getattr(torch, fcn_dtype),
                                                device=dev)
                with span("fcn.forward"):
                    sal = fcn_saliency_image(band, model, model_name=model_name,
                                             method=method, device=dev).cpu().numpy()
                with span("fcn.write", bytes=sal.nbytes):
                    meta = {"data ignore value": -9999}
                    if "map info" in img.metadata:
                        meta["map info"] = img.metadata["map info"]
                    envi_io.save_envi(salf + ".part.hdr", sal, metadata=meta,
                                      interleave="bip")
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
            with Stage("salience", timers, progress, dev):
                os.makedirs(detdir, exist_ok=True)
                with span("salience.read") as s:
                    cmfimg = envi_io.open_envi(cmff)
                    salmm = envi_io.open_envi(salf).load().squeeze()
                    cmfarr = cmfimg.load()
                    s.count(bytes=salmm.nbytes + cmfarr.nbytes)
                with span("salience.detect"):
                    detdf = salience2detections(salmm, cmfarr, prob_thr,
                                                ppmm_thr, lid, mapinfo(cmfimg), detdir,
                                                quicklooks=quicklooks)
                if len(detdf):
                    with span("salience.write") as s:
                        save_detections(xlsxf, detdf)
                        s.count(bytes=os.path.getsize(xlsxf) + os.path.getsize(csvf))
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
                with Stage("ime", timers, progress, dev):
                    compute_ime_for_cmf(cmff, out_csv=imef)

        # ---- L5b: winds / emissions ------------------------------------------
        if winds and products["detections_csv"] and os.path.exists(products["detections_csv"]):
            outcsv = os.path.join(outdir, stem + "_plumes_enriched.csv")
            products["enriched_csv"] = outcsv
            if os.path.exists(outcsv):
                progress(f"[SKIP] enriched list exists: {outcsv}")
            else:
                with Stage("msf-flow", timers, progress, dev):
                    # the plume list's name carries the minppmm tag msf-flow
                    # parses (msf_flow.py:124-144)
                    tagged = os.path.join(outdir, f"{stem}_plumes_minppmm{int(ppmm_thr)}.csv")
                    pdf = pd.read_csv(products["detections_csv"])
                    imef = products.get("ime_csv")
                    if imef and os.path.exists(imef):
                        # attach AvgIMEdivFetch20/StdIMEdivFetch20/Aspect ratio20,
                        # the emission rate's inputs (the reference's compute-ime
                        # job updates the plume list the same way)
                        try:
                            ime_df = pd.read_csv(imef)
                        except pd.errors.EmptyDataError:   # zero detections
                            ime_df = pd.DataFrame()
                        merge_ime_into_plumelist(pdf, ime_df)
                    pdf.to_csv(tagged, index=False)
                    plumes = process_plumes([tagged], winds, ext=wind_ext, device=dev)
                    insert_plumes_in_file(plumes, outcsv)

        products["timers"] = timers
    products["spans"] = spans(root.trace_id)
    return products


def build_parser():
    p = argparse.ArgumentParser(
        description="srcfinder (PyTorch/CUDA): radiance -> CMF [+ masks] -> "
                    "saliency -> plume list [-> IME -> winds] in one command")
    p.add_argument("radiance", nargs="?", default=None,
                   help="radiance flightline (ENVI); optional with --watch")
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
                        "dilated: dense passes in halo-exact line windows past "
                        "a 2.5 Mpx canvas, 3,647 lines at width 598)")
    p.add_argument("--winds", default=None,
                   help="wind-grid directory (enables the emission stage)")
    p.add_argument("--wind-ext", default=".grib2", choices=[".grib2", ".npz"])
    p.add_argument("--ime", action="store_true")
    p.add_argument("--quicklooks", action="store_true",
                   help="a PDF per candidate beside the plume list")
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
    p.add_argument("--watch", default=None,
                   help="watch a directory for new radiance files instead of "
                        "processing one")
    p.add_argument("--watch-regex", default=r".*_rdn.*img$")
    p.add_argument("--once", action="store_true",
                   help="with --watch: process the current backlog and exit")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    kwargs = dict(library=args.library, weights=args.weights,
                  outdir=args.outdir, model_name=args.model,
                  prob_thr=args.prob_thr, ppmm_thr=args.ppmm_thr,
                  method=args.method, winds=args.winds, wind_ext=args.wind_ext,
                  do_ime=args.ime, do_masks=args.masks,
                  quicklooks=args.quicklooks, dtype=args.dtype,
                  fcn_dtype=args.fcn_dtype, bgmodes=args.bgmodes,
                  col_chunk=args.col_chunk, device=args.device)

    if args.watch:
        jobq = JobQueue()
        jobq.register("flightline",
                      lambda params: run_flightline(params["path"], **kwargs))
        first = True
        while True:
            # the first cycle takes the existing backlog (the DirWatcher's
            # cursor starts at 'now' when it has no state file)
            watch_and_trigger(args.watch, "flightline", jobq,
                              regex=args.watch_regex, force=first)
            first = False
            for failure in jobq.failures:
                print(f"[FAIL] {failure}", file=sys.stderr)
            if args.once:
                return 1 if jobq.failures else 0
            time.sleep(5)

    if not args.radiance:
        print("radiance file or --watch required", file=sys.stderr)
        return 2
    products = run_flightline(args.radiance, **kwargs)
    for k, v in products.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
