"""CLI: gaussian-PSF downsampling of a flightline
(reference: cnn/posthoc_down.py argparse surface: srcfl dstfl [-res R]
[--nodata V]; rotated inputs are warped north-up first exactly like the
reference's gdalwarp preproc, posthoc_down.py:50-60 — via core.warp).

usage: python -m srcfinder_torch.detect.downsample_cli SRC DST [-r 30]
       [--band 1] [--nodata -9999] [--device cuda|cpu]

Port of the JAX package's ``detect/downsample_cli.py``: ENVI band -> warp
if rotated -> downsample (on ``--device``) -> ENVI, with the same map-info
rewrite.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        description="Generate gaussian downsampled flightlines")
    p.add_argument("srcfl", type=str, help="Source flightline filename")
    p.add_argument("dstfl", type=str, help="Destination flightline filename")
    p.add_argument("-res", "-r", dest="res", type=float, default=30,
                   help="Target resolution")
    p.add_argument("--band", type=int, default=1, help="1-based band")
    p.add_argument("--nodata", type=float, default=-9999,
                   help="NODATA value of dstfl")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    import numpy as np
    from ..core import envi as envi_io
    from ..core.geo import mapinfo
    from .posthoc_down import gaussian_downsample

    args = build_parser().parse_args(argv)
    img = envi_io.open_envi(args.srcfl)
    data = np.asarray(img.read_band(args.band - 1), dtype=np.float32)
    m = mapinfo(img)
    if m and float(m.get("rotation", 0) or 0) != 0:
        from ..core.warp import warp_north_up
        data, m = warp_north_up(data, m, nodata=args.nodata)
        print("warped rotated input north-up")
    src_res = float(m["xps"]) if m else 1.0
    out = gaussian_downsample(data, src_res, args.res, nodata=args.nodata,
                              device=args.device).cpu().numpy()
    meta = {"data ignore value": args.nodata}
    if m:
        m2 = dict(m)
        m2["xps"] = args.res
        m2["yps"] = args.res
        maplist = [m2["proj"], m2["xtie"], m2["ytie"], m2["ulx"], m2["uly"],
                   m2["xps"], m2["yps"]]
        if m2["proj"] == "UTM":
            maplist += [m2["zone"], m2["hemi"], m2.get("datum", "WGS-84")]
        meta["map info"] = [str(v) for v in maplist]
    envi_io.save_envi(args.dstfl + ".hdr", out.astype(np.float32),
                      metadata=meta, interleave="bip")
    print(f"saved {args.dstfl} ({out.shape[0]}x{out.shape[1]} @ {args.res}m)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
