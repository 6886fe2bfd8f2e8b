"""CLI: convert GRIB2 wind files to the framework's npz wind grids.

The reference reads GRIB2 directly via pygrib everywhere; this framework
also decodes real HRRR/RTMA GRIB2 (flow/windgrid.py — complex packing +
Lambert grids), and this tool materializes the decoded grids as .npz for
faster repeated access (the npz reader skips the bit-unpacking).

    python -m srcfinder_torch.flow.grib_cli FILE.grib2 [FILE2 ...] [-o OUTDIR]
        [--alts 10 80]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .windgrid import read_wind_grid


def main(argv=None):
    p = argparse.ArgumentParser(
        description="GRIB2 -> npz wind-grid converter (srcfinder, PyTorch/CUDA)")
    p.add_argument("files", nargs="+", help="GRIB2 files")
    p.add_argument("--outdir", "-o", default=".")
    p.add_argument("--alts", type=int, nargs="+", default=[10],
                   help="altitudes (m) to extract (80 only in HRRR)")
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    rc = 0
    for f in args.files:
        out = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(f))[0] + ".npz")
        try:
            payload = {}
            for alt in args.alts:
                g = read_wind_grid(f, alt=alt)
                suffix = "" if alt == 10 else f"_{alt}"
                payload.update({f"u{suffix}": g.u, f"v{suffix}": g.v})
            payload.update(lat=g.lat, lon=g.lon, gust=g.gust,
                           valid_date=g.valid_date.isoformat())
            np.savez(out, **payload)
            print(f"{f} -> {out}")
        except Exception as e:   # keep-going like every reference loop
            print(f"FAILED {f}: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
