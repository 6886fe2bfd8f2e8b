"""CLI: salience map -> plume candidate list
(reference: salience_predictions.py:194-243).

    python -m srcfinder_torch.detect.salience_cli SALIENCE_IMAGE CMF_IMAGE
        [--prob_thr P] [--ppmm_thr T] [--model_version v2] [--outdir DIR]
        [--quicklooks]

Host numpy/scipy, as in the JAX package's ``detect/salience_cli.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..core import envi as envi_io
from ..core.geo import mapinfo
from .salience import salience2detections, save_detections


def build_parser():
    p = argparse.ArgumentParser(
        description="Salience Map -> Prediction Summary")
    p.add_argument("--prob_thr", type=float, default=0.5,
                   help="Salience threshold (default=0.50)")
    p.add_argument("--ppmm_thr", type=float, default=250,
                   help="PPMM threshold (default=250.00)")
    p.add_argument("--model_version", type=str, default="v2",
                   help="MSF model version (default=v2)")
    p.add_argument("--outdir", type=str, default=".",
                   help="Output path for detection lists")
    p.add_argument("--quicklooks", action="store_true",
                   help="emit per-candidate PDF quicklooks")
    p.add_argument("salience_image", type=str, help="Salience map image file")
    p.add_argument("cmf_image", type=str, help="CMF image file")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    salimg = envi_io.open_envi(args.salience_image)
    cmfimg = envi_io.open_envi(args.cmf_image)
    salmm = salimg.load().squeeze()
    cmfmm = cmfimg.load()
    cmfmap = mapinfo(cmfimg)
    cmfbase = os.path.basename(args.cmf_image)
    cmflid = cmfbase.split("_")[0]
    outdir = os.path.join(args.outdir or ".", cmfbase + "_detections")
    os.makedirs(outdir, exist_ok=True)

    detdf = salience2detections(salmm, cmfmm, args.prob_thr, args.ppmm_thr,
                                cmflid, cmfmap, outdir,
                                quicklooks=args.quicklooks)
    if len(detdf) > 0:
        detstrs = [cmfbase, args.model_version,
                   "minsal%.2f" % args.prob_thr,
                   "minppmm%.1f" % args.ppmm_thr]
        detoutf = "_".join(detstrs).replace(".", "p") + ".xlsx"
        csvf = save_detections(os.path.join(outdir, detoutf), detdf)
        print("saved", csvf)
    else:
        print("No plume detections above minsal=%.2f found in %s"
              % (args.prob_thr, args.salience_image))
    return 0


if __name__ == "__main__":
    sys.exit(main())
