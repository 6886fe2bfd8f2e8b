"""CLI: batch spectrometer mask generation
(reference: spectrometer_masks/masks_sds.py:62-107 argparse surface).

usage: python -m srcfinder_torch.masks.cli --txt FLIGHTS.txt --inpath DIR
           --outpath DIR [-T THR] [-dark THR] [-C THR] [-B 150m] [-M 150m]
           [-A PX] [--device cuda|cpu] [...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..core import envi as envi_io
from .sds import MaskParams, get_radius_in_pixels, masks_for_cube

__all__ = ["mask_output_name", "flightline_mask_config", "masks_for_flightline",
           "build_parser", "main"]

SCRIPT_VERSION = "1.0.0"


def build_parser():
    p = argparse.ArgumentParser(
        description="Flare/cloud/specular/dark masks for AVIRIS-NG "
                    f"radiance files (PyTorch/CUDA). v{SCRIPT_VERSION}",
        add_help=False, allow_abbrev=False)
    p.add_argument("--txt", type=str, required=True,
                   help="Text file listing radiance files to batch process")
    p.add_argument("--inpath", type=str, required=True,
                   help="Path containing orthocorrected radiance files")
    p.add_argument("--outpath", type=str, required=True,
                   help="Path to write outputs to")
    p.add_argument("-T", "--saturationthreshold", type=float, default=None)
    p.add_argument("-dark", "--dark_threshold", type=float, default=0.104)
    p.add_argument("-C", "--cldthreshold", type=float, nargs=1, default=[15.0])
    p.add_argument("-W", "--saturationwindow", type=float, nargs=2,
                   metavar=("LOW", "HIGH"), default=None)
    p.add_argument("-D", "--cldbands", type=float, nargs=2, default=None)
    p.add_argument("-B", "--cldbfr", type=str, default="150m")
    p.add_argument("-M", "--maskgrowradius", type=str, default="150m")
    p.add_argument("-A", "--mingrowarea", type=int, nargs="?", const=5, default=None)
    p.add_argument("--saturation-processing-block-length", type=int,
                   default=500, dest="block_step")
    p.add_argument("--visible-mask-growing-threshold", type=float,
                   default=9.0, dest="vis_thr")
    p.add_argument("-o", "--overwrite", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the per-pixel tests (cuda raises without a card)")
    p.add_argument("-h", "--help", action="help")
    return p


def mask_output_name(f_txt: str) -> str:
    """xxxYYYYMMDDtHHMMSS_rdn_v2x1_img -> xxxYYYYMMDDtHHMMSS_msk_v2x1_img
    (reference: masks_sds.py:380-389)."""
    parts = f_txt.split("_")
    if len(parts) >= 3 and parts[1] == "rdn":
        return "_".join([parts[0], "msk"] + parts[2:])
    return f_txt + "_msk"


def flightline_mask_config(rdn, rdn_path="", *, saturationthreshold=None,
                           saturationwindow=None, cld_threshold=15.0,
                           cldbands=None, dark_threshold=0.104,
                           cldbfr="150m", maskgrowradius="150m", vis_thr=9.0):
    """The flightline's MaskParams and pixel radii from its ENVI header:
    band indices from the wavelength list (the reference hardcodes
    AVIRIS-NG band numbers, masks_sds.py:49-59), radii from the map info.
    Reads only the header, so it validates the metadata before any device
    work: ValueError without a wavelength list, RuntimeError when a radius
    in meters meets a map info without meters."""
    centers = rdn.bands.centers
    if not centers:           # None or [] when the header has no list
        raise ValueError(f"no wavelength metadata in {rdn_path}; the "
                         "spectrometer masks need band centers")
    wavelengths = np.array(centers, dtype=np.float64)

    def nearest(nm):
        return int(np.argmin(np.abs(wavelengths - nm)))
    cld = (tuple(nearest(nm) for nm in (450., 670., 1250.)) if cldbands is None
           else (nearest(cldbands[0]), nearest(670.), nearest(cldbands[1])))
    params = MaskParams(
        saturation_threshold=(saturationthreshold
                              if saturationthreshold is not None else 6.0),
        saturation_window=(tuple(saturationwindow) if saturationwindow
                           else (1945., 2485.)),
        cld_threshold=cld_threshold,
        cld_bands=cld,
        dark_band=nearest(2139.),
        spec_band=nearest(505.),
        dark_threshold=dark_threshold,
        vis_grow_threshold=vis_thr)
    grow_px = (get_radius_in_pixels(maskgrowradius, rdn.metadata)
               if maskgrowradius else None)
    cld_px = get_radius_in_pixels(cldbfr, rdn.metadata) if cldbfr else 0.0
    return params, grow_px, cld_px, wavelengths


def masks_for_flightline(rdn_path: str, outpath: str, *,
                         saturationthreshold=None, saturationwindow=None,
                         cld_threshold=15.0, cldbands=None,
                         dark_threshold=0.104, cldbfr="150m",
                         maskgrowradius="150m", mingrowarea=5,
                         block_step=500, vis_thr=9.0, device="cuda",
                         out_name=None, tap=None, tap_bands=None, timers=None):
    """The 4-band QC mask of one radiance flightline, written next to
    ``outpath`` (an existing product is overwritten); returns the output
    image's basename.

    ``tap(r0, r1, block, pos)``: optional observer of every streamed line
    block, so a caller can fill other products (the pipeline's CMF slabs)
    from this one read of the cube. ``block`` is (rows, cols, len(req))
    float32 holding the union of the masks' bands, band 0 (nodata) and
    ``tap_bands``; ``pos`` maps a band index to its position in
    ``block``'s last axis. Only those bands are read from disk.
    ``device``: "cuda" (default; raises without a card) or "cpu".
    ``timers``: optional dict that receives the seconds of the phase's
    parts: the disk reads and the taps (in the reader thread), the pixel
    tests, the host growth and the waits for a block (see
    :func:`.sds.masks_for_cube`)."""
    rdn = envi_io.open_envi(rdn_path)
    params, grow_px, cld_px, wavelengths = flightline_mask_config(
        rdn, rdn_path, saturationthreshold=saturationthreshold,
        saturationwindow=saturationwindow, cld_threshold=cld_threshold,
        cldbands=cldbands, dark_threshold=dark_threshold, cldbfr=cldbfr,
        maskgrowradius=maskgrowradius, vis_thr=vis_thr)
    # nodata is collected during the streaming read; overlap re-reads
    # rewrite the same rows
    nod = np.zeros((rdn.nrows, rdn.ncols), bool)
    state = {}
    clock = {"read": 0.0, "tap": 0.0}

    def read_block_bands(r0, r1, bands):
        if "req" not in state:
            state["req"] = sorted(set(int(b) for b in bands) | {0}
                                  | set(int(b) for b in (tap_bands or [])))
            state["pos"] = {b: i for i, b in enumerate(state["req"])}
            state["sel"] = [state["pos"][int(b)] for b in bands]
        pos = state["pos"]
        t0 = time.perf_counter()
        blk = np.asarray(rdn.read_lines_bands(r0, r1, state["req"]), np.float32)
        t1 = time.perf_counter()
        clock["read"] += t1 - t0
        if tap is not None:
            tap(r0, r1, blk, pos)
            clock["tap"] += time.perf_counter() - t1
        nod[r0:r1] = blk[:, :, pos[0]] == -9999
        return blk[:, :, state["sel"]]

    out = masks_for_cube(
        read_block_bands=read_block_bands, nrows=rdn.nrows, ncols=rdn.ncols,
        wavelengths=wavelengths, params=params, maskgrowradius_px=grow_px,
        mingrowarea=mingrowarea, cldbfr_px=cld_px, block_step=block_step,
        nodata_row0=lambda: nod, device=device, timers=timers)
    if timers is not None:
        timers.update(clock)

    meta = {
        "description": "Flare and cloud mask (srcfinder_torch).",
        "band names": ["Cloud mask (dimensionless)",
                       "Specular mask (dimensionless)",
                       "Flare mask (dimensionless)",
                       "Dark mask (dimensionless)"],
        "data ignore value": -9999,
    }
    if "map info" in rdn.metadata:
        meta["map info"] = rdn.metadata["map info"]
    stem = os.path.splitext(os.path.basename(rdn_path))[0]
    if stem.endswith(".hdr"):
        stem = os.path.splitext(stem)[0]
    outname = out_name or mask_output_name(stem)
    envi_io.save_envi(os.path.join(outpath, outname + ".hdr"), out,
                      metadata=meta, interleave="bil", force=True)
    return outname


def main(argv=None):
    args = build_parser().parse_args(argv)
    print("Arguments:")
    print(args)

    with open(args.txt) as fd:
        files = fd.read().splitlines()

    for f_txt in files:
        if not f_txt.strip():
            continue
        print("Processing flight", f_txt)
        # existing products are regenerated only with --overwrite
        outname = mask_output_name(f_txt)
        if not args.overwrite and os.path.exists(os.path.join(args.outpath, outname)):
            print("Skipping existing " + outname)
            continue
        outname = masks_for_flightline(
            os.path.join(args.inpath, f_txt + ".hdr"), args.outpath,
            saturationthreshold=args.saturationthreshold,
            saturationwindow=args.saturationwindow,
            cld_threshold=args.cldthreshold[0], cldbands=args.cldbands,
            dark_threshold=args.dark_threshold, cldbfr=args.cldbfr,
            maskgrowradius=args.maskgrowradius, mingrowarea=args.mingrowarea,
            block_step=args.block_step, vis_thr=args.vis_thr,
            device=args.device, out_name=outname)
        print("Generated " + outname)
    print("Completed all scenes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
