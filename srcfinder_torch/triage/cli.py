"""CLI: CMF column-profile generation
(reference: triage/cmf_profile.py:46-77 argparse surface).

usage: python -m srcfinder_torch.triage.cli [-v] [--robust] [-j JOBS]
           [--plot] [--randomize] [--outdir DIR] [--device cuda|cpu]
           cmf_files...
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("srcfinder-triage")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--robust", action="store_true",
                   help="Use robust statistics")
    p.add_argument("-j", "--jobs", type=int, default=1,
                   help="Number of parallel jobs (1 job per image)")
    p.add_argument("--plot", action="store_true",
                   help="Plot column statistics")
    p.add_argument("--randomize", action="store_true",
                   help="Randomize cmffiles processing order")
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the column statistics (cuda raises "
                        "without a card)")
    p.add_argument("cmffiles", type=str, nargs="+", metavar="cmf_file")
    return p


def main(argv=None):
    from .profile import plot_stats, profile_files

    args = build_parser().parse_args(argv)
    files = list(args.cmffiles)
    if len(files) > 1 and args.randomize:
        files = list(np.array(files)[np.random.permutation(len(files))])
    results = profile_files(files, outdir=args.outdir,
                            use_robust_stats=args.robust, n_jobs=args.jobs,
                            device=args.device)
    if args.plot:
        for f in files:
            outbase = os.path.splitext(os.path.basename(f))[0]
            colcsv = os.path.join(args.outdir, outbase + "_column_stats.csv")
            if os.path.exists(colcsv):
                plot_stats(f, colcsv, use_robust_stats=args.robust)
    if args.verbose:
        for f, r in zip(files, results):
            print(f, "->", r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
