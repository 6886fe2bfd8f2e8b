"""CLI for the robust matched filter, flag-compatible with the reference
(reference: cmf/robust_mf.py:139-167).

usage: python -m srcfinder_torch.cmf.cli [-v] [-k K] [--pcadim N] [-r] [-f]
           [-m] [-R] [-M MODEL] [--rgb_bands R,G,B] [--dtype float32|float64]
           [--col_chunk N] [--cond_thresh T] [--device cuda|cpu]
           INPUT LIBRARY OUTPUT
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser():
    parser = argparse.ArgumentParser(description="Robust MF (PyTorch/CUDA)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="verbose output")
    parser.add_argument("-k", "--kmeans", type=int, default=1,
                        help="number of columnwise modes (k-means clusters)")
    parser.add_argument("--pcadim", type=int, default=6,
                        help="number of PCA dims (for k-means clusters>1)")
    parser.add_argument("-r", "--reject", action="store_true",
                        help="enable multimodal covariance outlier rejection")
    parser.add_argument("-f", "--full", action="store_true",
                        help="regularize multimodal estimates with the full "
                             "column covariance")
    parser.add_argument("--rgb_bands", default="60,42,24",
                        help="comma-separated list of RGB channels")
    parser.add_argument("-m", "--metadata", action="store_true",
                        help="save metadata image")
    parser.add_argument("-R", "--reflectance", action="store_true",
                        help="reflectance signature")
    parser.add_argument("-M", "--model", type=str, default="looshrinkage",
                        help="model name (looshrinkage (default)|empirical)")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "float64"],
                        help="compute precision")
    parser.add_argument("--col_chunk", type=int, default=256,
                        help="columns per device batch")
    parser.add_argument("--cond_thresh", type=float, default=1e-6,
                        help="float32 path: columns whose whitened-"
                             "covariance condition (lam_min/lam_max) falls "
                             "below this are recomputed in float64 on the "
                             "same device (0 disables)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="compute device (cuda raises without a card)")
    parser.add_argument("input", type=str, metavar="INPUT",
                        help="path to input image")
    parser.add_argument("library", type=str, metavar="LIBRARY",
                        help="path to target library file")
    parser.add_argument("output", type=str, metavar="OUTPUT",
                        help="path for output image (mf ch4 ppm)")
    return parser


def main(argv=None):
    import numpy as np
    from .pipeline import robust_mf_image

    args = build_parser().parse_args(argv)
    if not os.path.isfile(args.library):
        print(f'library file not found: "{args.library}"')
        return 1
    rgb = [] if args.rgb_bands == "[]" else [int(b) for b in
                                             args.rgb_bands.split(",")]
    print('started processing input file: "%s"' % args.input)
    stime = time.time()
    out = robust_mf_image(
        args.input, args.library, args.output,
        model=args.model, bgmodes=args.kmeans, pcadim=args.pcadim,
        reject=args.reject, regfull=args.full, reflectance=args.reflectance,
        rgb_bands=rgb, save_bgmeta=args.metadata,
        col_chunk=args.col_chunk,
        dtype=np.float64 if args.dtype == "float64" else np.float32,
        verbose=args.verbose, cond_thresh=args.cond_thresh,
        device=args.device)
    print("Saved column stats to", out["colcsv"])
    print("done (elapsed time=%ds)" % (time.time() - stime))
    return 0


if __name__ == "__main__":
    sys.exit(main())
