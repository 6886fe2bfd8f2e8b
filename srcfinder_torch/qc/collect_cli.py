"""CLI: merge submitted QC labels into consensus label sets
(reference: cmftagger/collect_qcdata.py script surface).

usage: python -m srcfinder_torch collect-qc OUTPUT_DIR --lidfilters lidfilters.json
       --outprefix CAMPAIGN [--users u1 u2] [--auto-resolve y|n|m]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    from .collect import collect_qcdata

    p = argparse.ArgumentParser(description="Collect + merge QC labels")
    p.add_argument("output_dir", help="cmftagger output dir (per-user)")
    p.add_argument("--lidfilters", required=True,
                   help="per-flag accept/reject vocabulary JSON "
                        "(reference: cmftagger/config/lidfilters.json)")
    p.add_argument("--outprefix", required=True)
    p.add_argument("--users", nargs="*", default=None)
    p.add_argument("--auto-resolve", default="m", choices=["y", "n", "m"],
                   help="flightline conflict resolution (reject/keep/"
                        "ambiguous) instead of the interactive prompt")
    args = p.parse_args(argv)

    with open(args.lidfilters) as f:
        lidfilters = json.load(f)
    ciddf, liddf = collect_qcdata(
        args.output_dir, lidfilters, args.outprefix, users=args.users,
        resolver=lambda lid, df: args.auto_resolve)
    print(f"{len(liddf)} flightline rows, {len(ciddf)} final candidates")
    print(f"wrote {args.outprefix}_cid_filt_nodup_norej_noamb.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
