"""CLI: one flightline through the port in one command.

    python -m srcfinder_torch.flow.pipeline_cli RADIANCE --library LIB \\
        --weights W.npz -o OUT [--ime] [--device cuda|cpu]

runs radiance -> CMF -> FCN saliency -> plume candidates (xlsx+csv)
[-> IME stats], with per-stage idempotent skips (existing outputs are
reused — the reference's resume convention) and per-stage wall-clock
timers. Products are written as ``<name>.part`` and renamed when
complete, so a stage killed mid-write never leaves a final-named partial
product for the next run to trust.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..cmf.pipeline import robust_mf_image
from ..core import envi as envi_io
from ..core.geo import mapinfo
from ..detect.fcn_pipeline import fcn_saliency_image, load_saliency_model
from ..detect.salience import salience2detections, save_detections
from ..device import resolve_device
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


def run_flightline(radiance: str, library: str, weights: str, outdir: str,
                   model_name: str = "multi_64", prob_thr: float = 0.5,
                   ppmm_thr: float = 250.0, method: str = "auto",
                   do_ime: bool = False, dtype="float32",
                   col_chunk: int = 256, progress=print, device="cuda"):
    """Run all stages for one flightline; returns a dict of products
    (paths) plus ``timers`` (seconds per stage).

    ``device``: "cuda" (default; raises without a card) or "cpu".
    """
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(radiance))[0]
    lid = stem.split("_")[0]
    products: dict = {}
    timers: dict = {}

    # ---- L2: CMF ---------------------------------------------------------
    cmff = os.path.join(outdir, stem.replace("_rdn", "_cmf")
                        if "_rdn" in stem else stem + "_cmf")
    products["cmf"] = cmff
    if os.path.exists(cmff):
        progress(f"[SKIP] CMF exists: {cmff}")
    else:
        with _Stage("cmf", timers, progress):
            robust_mf_image(radiance, library, cmff + ".part",
                            dtype=np.dtype(dtype).type, col_chunk=col_chunk,
                            device=dev)
            _finalize((cmff + ".part", cmff))

    # ---- L3: FCN saliency ------------------------------------------------
    salf = os.path.join(outdir, os.path.basename(cmff) + "_saliency")
    products["saliency"] = salf
    if os.path.exists(salf):
        progress(f"[SKIP] saliency exists: {salf}")
    else:
        with _Stage("fcn", timers, progress):
            img = envi_io.open_envi(cmff)
            band = np.asarray(img.read_band(-1), dtype=np.float32)
            model = load_saliency_model(weights, device=dev)
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
        description="srcfinder (PyTorch/CUDA): radiance -> CMF -> saliency "
                    "-> plume list [-> IME] in one command")
    p.add_argument("radiance", help="radiance flightline (ENVI)")
    p.add_argument("--library", required=True,
                   help="unit-absorption library (name selects the gas "
                        "window, e.g. *ch4*.txt)")
    p.add_argument("--weights", required=True,
                   help="FCN weights (.npz in the Flax layout, or .pt)")
    p.add_argument("--outdir", "-o", default=".")
    p.add_argument("--model", default="multi_64")
    p.add_argument("--prob_thr", type=float, default=0.5)
    p.add_argument("--ppmm_thr", type=float, default=250.0)
    p.add_argument("--method", default="auto",
                   choices=["auto", "shift", "phase"])
    p.add_argument("--ime", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"], help="CMF precision")
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
        dtype=args.dtype, col_chunk=args.col_chunk, device=args.device)
    for k, v in products.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
