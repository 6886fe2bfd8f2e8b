"""Standalone stage CLIs for the msf_flow worker scripts.

The reference ships each workflow stage as an independently runnable
script in addition to the orchestrator; these thin mains mirror those
argv surfaces over the already-tested APIs:

- ``srcfinder-cluster``       msf_flow/cluster/cluster_incr_nn.py:20-29
  (``plumes output -r RADIUS [-v]``)
- ``srcfinder-dedup``         msf_flow/plume_processor/filter_plumes/
  remove_duplicate_plumes.py:47-55 (``plumes output [--max_overlap]``)
- ``srcfinder-station-winds`` msf_flow/wind_processor/station_winds.py:17-25
  (``plumes output token``)
- ``srcfinder-windspeed``     msf_flow/wind_processor/running_windspeed.py:14-25
  (``-p GLOB -w WINDIR [-a ALT]``)
- ``srcfinder-wind-qc``       msf_flow/harvester/wind_quality_check.py:22-28
  (``-f FILE``)
- ``srcfinder-persistence``   msf_flow/plume_processor/source_persistence/
  source_persistence.py:105-230 (``source_list flightlines.shp output``)
- ``srcfinder-inversion``     msf_flow/deployment/inversion-run/
  inversion-run.py:12-141 (``grid_dir [--rsel3 --tropH --plot]``)

Recorded deviations (also in PARITY.md):
- cluster ``-v`` writes ``OUTPUT.pdf`` instead of opening the
  pyclustering interactive window (headless deployment).
- dedup ``--max_overlap`` actually reaches the filter; the reference
  parses it (:51) but ``flux_overest`` -> ``filter_plumes`` re-pins
  ``max_overlap_default`` (:351), so its flag is dead.
- windspeed adds optional ``-o OUT.csv``; the reference only logs the
  enriched records (running_windspeed.py:96-119) and writes no file.
- station-winds/windspeed read any ``*.csv`` plume list via the same
  reader the orchestrator uses.

The port's copy of the JAX package's ``flow/stage_clis.py``, with the same
argv and files. ``srcfinder-inversion`` and ``srcfinder-windspeed`` take
``--device`` (default ``cuda``, which raises without a card; ``cpu`` runs
on the host): the inversion's solves and the windspeed's nearest-cell
search run on it, as every port CLI's device work does.
"""

from __future__ import annotations

import argparse
import glob
import sys


def cluster_main(argv=None):
    """``srcfinder-cluster PLUMES OUTPUT -r RADIUS [-v]``."""
    p = argparse.ArgumentParser(
        prog="srcfinder-cluster",
        description="Incremental nearest-neighbor source clustering "
                    "(appends a Source ID column)")
    p.add_argument("plumes", help="path to input plume file")
    p.add_argument("output", help="path to output plume file")
    p.add_argument("-r", "--radius", required=True, type=float,
                   help="clustering radius in meters")
    p.add_argument("-v", "--visualize", action="store_true",
                   help="write OUTPUT.pdf cluster scatter (the "
                        "reference opens an interactive window)")
    args = p.parse_args(argv)
    from .cluster import cluster_plume_list
    rows = cluster_plume_list(args.plumes, args.output,
                              radius=args.radius)
    print(f"{len(rows)} plumes -> {args.output}")
    if args.visualize and rows:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        lon = [float(r["Plume Longitude (deg)"]) for r in rows]
        lat = [float(r["Plume Latitude (deg)"]) for r in rows]
        sids = [r["Source ID"] for r in rows]
        order = {s: i for i, s in enumerate(dict.fromkeys(sids))}
        fig, ax = plt.subplots(figsize=(6, 6))
        sc = ax.scatter(lon, lat, c=[order[s] for s in sids],
                        cmap="tab20", s=12)
        ax.set_xlabel("longitude")
        ax.set_ylabel("latitude")
        ax.set_title(f"{len(order)} sources (radius {args.radius} m)")
        fig.colorbar(sc, label="source index")
        fig.savefig(args.output + ".pdf")
        plt.close(fig)
        print(f"wrote {args.output}.pdf")
    return 0


def dedup_main(argv=None):
    """``srcfinder-dedup PLUMES OUTPUT [--max_overlap 0.30]``."""
    p = argparse.ArgumentParser(
        prog="srcfinder-dedup",
        description="Remove duplicate/overlapping plumes from a plume "
                    "list (Duren et al. SI S2.5/S2.8)")
    p.add_argument("plumes", help="path to input plume file")
    p.add_argument("output", help="path to output plume file")
    p.add_argument("--max_overlap", type=float, default=None,
                   help="max allowable fractional search-radius overlap "
                        "(default 0.30)")
    args = p.parse_args(argv)
    import pandas as pd
    from .dedup import MAX_OVERLAP_DEFAULT, remove_duplicate_plumes
    mo = (MAX_OVERLAP_DEFAULT if args.max_overlap is None
          else args.max_overlap)
    df = pd.read_csv(args.plumes)
    out = remove_duplicate_plumes(df, max_overlap=mo)
    # the reference writes with the index column (:497)
    out.to_csv(args.output, index=True)
    print(f"{len(df)} -> {len(out)} plumes ({args.output})")
    return 0


def station_winds_main(argv=None):
    """``srcfinder-station-winds PLUMES OUTPUT TOKEN``."""
    p = argparse.ArgumentParser(
        prog="srcfinder-station-winds",
        description="Append Mesowest weather-station wind columns to a "
                    "plume list")
    p.add_argument("plumes", help="path to input plume file")
    p.add_argument("output", help="path to output plume file")
    p.add_argument("token", help="token for access to station data")
    args = p.parse_args(argv)
    from csv import DictWriter

    from .stations import get_station_data_for_plume
    from .wind import read_plumes
    plumes = read_plumes(args.plumes)
    for plume in plumes:
        plume.update(get_station_data_for_plume(plume, token=args.token))
    if not plumes:
        print("no plumes in input")
        return 1
    with open(args.output, "w", newline="") as fout:
        writer = DictWriter(fout, fieldnames=list(plumes[0].keys()))
        writer.writeheader()
        for plume in plumes:
            writer.writerow(plume)
    print("Plume file with source identification written to "
          f"{args.output}")
    return 0


def windspeed_main(argv=None):
    """``srcfinder-windspeed -p GLOB -w WINDIR [-a ALT] [-o OUT.csv]``."""
    p = argparse.ArgumentParser(
        prog="srcfinder-windspeed",
        description="Enrich plume lists with wind statistics and "
                    "emission rates from a wind-granule directory")
    p.add_argument("-p", "--plume_files", required=True,
                   help="glob of plume csv files")
    p.add_argument("-w", "--windir", required=True,
                   help="directory of wind granules")
    p.add_argument("-a", "--alt", type=int, default=10,
                   help="wind altitude in meters")
    p.add_argument("-o", "--output", default=None,
                   help="optional enriched csv (the reference only "
                        "logs the records)")
    p.add_argument("--wind-ext", default=".grib2",
                   help="wind granule format: .grib2 (the reference's) "
                        "or .npz")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the nearest-cell search (cuda raises "
                        "without a card)")
    args = p.parse_args(argv)
    from ..device import resolve_device
    from .emission import WindType, compute_emission_rate, \
        compute_wind_stats
    from .wind import gather_plumes
    dev = resolve_device(args.device)
    files = sorted(glob.glob(args.plume_files))
    plumes = gather_plumes(files)
    wind_type = WindType(args.windir).type_as_str()
    for plume in plumes:
        stats = compute_wind_stats(plume, args.windir,
                                   wind_type=wind_type,
                                   wind_alt=args.alt,
                                   ext=args.wind_ext, device=dev)
        plume.update(stats)
        plume.update(compute_emission_rate(plume, wind_type))
        print({k: plume[k] for k in plume if "wind" in k.lower()
               or "Emission" in k})
    if args.output and plumes:
        from csv import DictWriter
        with open(args.output, "w", newline="") as fout:
            writer = DictWriter(fout, fieldnames=list(plumes[0].keys()))
            writer.writeheader()
            for plume in plumes:
                writer.writerow(plume)
        print(f"wrote {args.output}")
    return 0


def persistence_main(argv=None):
    """``srcfinder-persistence SOURCE_LIST FLIGHTLINES.shp OUTPUT``:
    the source_persistence.py worker surface (reference:
    msf_flow/plume_processor/source_persistence/source_persistence.py:105-230
    — the Lambda passes source list + flightlines shapefile + output
    csv). Flightline names come from the shapefile's ``Flight_Run``
    attribute, falling back to ``Name.split()[0]`` exactly like the
    reference (:138-139)."""
    import os

    p = argparse.ArgumentParser(
        prog="srcfinder-persistence",
        description="Per-source CH4 persistence: observed plumes / "
                    "total overflights from a flightline shapefile")
    p.add_argument("source_list", help="plume-list csv")
    p.add_argument("flightlines", help="flightline polygon .shp "
                                       "(.dbf sibling for names)")
    p.add_argument("output", help="output csv")
    args = p.parse_args(argv)
    import pandas as pd

    from .persistence import (read_dbf_field, read_shapefile_polygons,
                              source_persistence)
    polys = read_shapefile_polygons(args.flightlines)
    dbf = os.path.splitext(args.flightlines)[0] + ".dbf"
    try:
        names = read_dbf_field(dbf, "Flight_Run")
    except (KeyError, OSError):
        try:
            names = [n.split()[0] for n in read_dbf_field(dbf, "Name")]
        except (KeyError, OSError):
            names = [f"fl{i}" for i in range(len(polys))]
    df = pd.read_csv(args.source_list)
    sid_key = ("Source identifier" if "Source identifier" in df
               else "Source ID")
    out = source_persistence(df, names, polys, sid_key=sid_key)
    out.to_csv(args.output, index=True)  # the reference writes the index
    print(f"{len(out)} sources -> {args.output}")
    return 0


def inversion_main(argv=None):
    """``srcfinder-inversion GRID_DIR [--rsel3 F --tropH F --plot]``:
    the inversion-run worker surface (reference:
    msf_flow/deployment/inversion-run/inversion-run.py:12-116 local
    mode: GRID_DIR/{lat,lon}.csv + trop_H.csv (Jacobian) + trop_meta.csv
    (xch4/back columns); writes x_hat.csv/S_hat.csv beside the inputs;
    prior x_a = 10, S_a = diag((0.5 x_a)^2), S_o = diag((0.1 y)^2)).
    ``--plot`` writes x_hat.png (the reference's plot_result, :119-141,
    saves nothing — its savefig is commented out). The prior and noise
    covariances are built on ``--device``, in float32."""
    import os

    p = argparse.ArgumentParser(
        prog="srcfinder-inversion",
        description="Linear-Gaussian flux inversion over a model grid")
    p.add_argument("grid_dir",
                   help="directory with lat.csv/lon.csv — or the "
                        "trop_meta.csv path itself (the reference "
                        "Lambda derives the grid dir from the rsel3 "
                        "key, inversion-run.py:143-147); the "
                        "wind/plume event runner passes the file")
    p.add_argument("--rsel3", default=None,
                   help="observation csv with xch4/back columns "
                        "(default GRID_DIR/trop_meta.csv)")
    p.add_argument("--tropH", default=None,
                   help="Jacobian csv, no header "
                        "(default GRID_DIR/trop_H.csv)")
    p.add_argument("--plot", action="store_true",
                   help="write GRID_DIR/x_hat.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the solves (cuda raises without a card)")
    args = p.parse_args(argv)
    import numpy as np
    import pandas as pd
    import torch

    from ..device import resolve_device
    from .inversion import bayesian_inversion, posterior_covariance
    dev = resolve_device(args.device)
    gdir, rsel3_path = args.grid_dir, args.rsel3
    if os.path.isfile(gdir):
        rsel3_path = rsel3_path or gdir
        gdir = os.path.dirname(gdir) or "."
    args.grid_dir = gdir
    rsel3 = pd.read_csv(rsel3_path or
                        os.path.join(gdir, "trop_meta.csv"))
    H = pd.read_csv(args.tropH or os.path.join(gdir, "trop_H.csv"),
                    header=None).values.astype(np.float32)
    y = (pd.to_numeric(rsel3["xch4"], errors="coerce")
         - pd.to_numeric(rsel3["back"], errors="coerce")).values \
        .astype(np.float32)
    H, y = torch.from_numpy(H).to(dev), torch.from_numpy(y).to(dev)
    x_a = torch.full((H.shape[1],), 10.0, device=dev)
    S_a = torch.diag((0.5 * x_a) ** 2)
    S_o = torch.diag((0.1 * y) ** 2)
    x_hat = bayesian_inversion(H, y, x_a, S_a, S_o, device=dev).cpu().numpy()
    S_hat = posterior_covariance(H, S_a, S_o, device=dev).cpu().numpy()
    xf = os.path.join(args.grid_dir, "x_hat.csv")
    sf = os.path.join(args.grid_dir, "S_hat.csv")
    np.savetxt(xf, x_hat, delimiter=",")
    np.savetxt(sf, S_hat, delimiter=",")
    print(f"x_hat written to csv {xf}")
    print(f"S_hat written to csv {sf}")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        lat = pd.read_csv(os.path.join(args.grid_dir, "lat.csv"))
        lon = pd.read_csv(os.path.join(args.grid_dir, "lon.csv"))
        grid = np.reshape(x_hat, (len(lat), len(lon)))
        fig, ax = plt.subplots()
        m = ax.pcolormesh(grid, vmin=0,
                          vmax=float(np.percentile(grid, 95)))
        fig.colorbar(m)
        fig.savefig(os.path.join(args.grid_dir, "x_hat.png"))
        plt.close(fig)
        print("wrote x_hat.png")
    return 0


def wind_qc_main(argv=None):
    """``srcfinder-wind-qc -f FILE``: exit 0 when the granule decodes,
    1 otherwise (the reference emails an alert on failure; hook an
    alerting command on a nonzero exit)."""
    p = argparse.ArgumentParser(
        prog="srcfinder-wind-qc",
        description="Validate a downloaded wind granule")
    p.add_argument("-f", "--filename", required=True,
                   help="wind granule to check")
    args = p.parse_args(argv)
    from .harvester import wind_quality_check
    ok = wind_quality_check(args.filename,
                            alert=lambda s, m: print(f"ALERT: {s}: {m}",
                                                     file=sys.stderr))
    print(f"{args.filename}: {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1
