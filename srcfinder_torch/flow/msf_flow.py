"""MSF workflow orchestrator: plume lists -> winds/emissions -> merged list.

Reference (msf_flow/workflow/msf_flow.py): watch a plume directory for new
CSVs, tag each plume with the minppmm threshold from the filename, enrich
each plume with wind stats per wind subdirectory/altitude + emission rates
+ Mesowest station data (a fork pool per plume), then merge into the
output CSV sorted by Candidate ID with a .bak backup.

Note recorded here: the reference module cannot even import at its v1
(a syntax error at msf_flow.py:23); this implementation follows its
documented intent (msf_flow/workflow/README.md).

Port of the JAX package's ``flow/msf_flow.py``: the nearest-cell search
of every wind statistic runs on the device given (``--device``, cuda by
default).

    python -m srcfinder_torch.flow.msf_flow -w WINDS -o OUT.csv \\
        (--flmode PLUMES_minppmmN.csv | -p PLUMEDIR | --store URI) \\
        [-n NPROCS] [--fill FILL] [--wind-ext .grib2|.npz] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import re
import sys
import tempfile
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from csv import DictReader, DictWriter
from functools import partial
from shutil import copyfile

from ..device import resolve_device
from .emission import WindType, compute_emission_rate, compute_wind_stats
from .utils import DirWatcher, init_logger

__all__ = ["process_plume", "process_plumes", "insert_plumes_in_file",
           "get_minppmm_from_fname", "main"]


def get_minppmm_from_fname(fname: str) -> int:
    """(reference: msf_flow.py:124-132)"""
    match = re.search(r"minppmm(\d+)", fname)
    if match is None:
        raise ValueError(f"No match for minppmm(\\d+) found in {fname}")
    return int(match[1])


def _dict_reader_plus_update(fname, extra):
    if fname.endswith(".xlsx"):
        # the reference's canonical plume list is Excel
        # (salience_predictions.py:187-192); read via the stdlib reader
        from ..core.xlsx import read_xlsx_rows
        rows = read_xlsx_rows(fname)
        header = [str(h).strip() if h is not None else "" for h in rows[0]]
        out = []
        for vals in rows[1:]:
            row = {k: ("" if v is None else str(v))
                   for k, v in zip(header, vals)}
            row.update(extra)
            out.append(row)
        return out
    with open(fname) as f:
        reader = DictReader(f, skipinitialspace=True)
        return [row.update(extra) or row for row in reader]


def process_plume(winds_dir, plume, fill=None, ext=".grib2",
                  station_fetch=None, device="cuda"):
    """Enrich one plume with wind stats for every wind subdir/altitude,
    emission rates, and station winds (reference: msf_flow.py:56-122)."""
    emission_stats = OrderedDict()
    subdirs = sorted(f for f in os.listdir(winds_dir)
                     if not f.startswith("."))
    for subdir in subdirs:
        wt = WindType(subdir)
        if wt.type_as_str() == "UNKNOWN":
            continue
        wind_type = wt.type_as_str()
        winds_subdir = os.path.join(winds_dir, subdir)
        for alt in sorted(wt.altitudes()):
            wind_stats = compute_wind_stats(plume, winds_subdir, fill=fill,
                                            wind_type=wind_type,
                                            wind_alt=alt, ext=ext,
                                            device=device)
            plume.update(wind_stats)
        emission_stats.update(compute_emission_rate(plume, wind_type,
                                                    fill=fill))
    if station_fetch is not None:
        from .stations import get_station_data_for_plume
        plume.update(get_station_data_for_plume(plume, fill=fill,
                                                fetch=station_fetch))
    plume.update(emission_stats)
    return plume


def process_plumes(flist, winds_dir, nprocs: int = 1, fill=None,
                   minppmm_key="Minimum Threshold (ppmm)", ext=".grib2",
                   station_fetch=None, device="cuda"):
    """Read + tag + enrich all plumes, sorted by the first field
    (reference: msf_flow.py:146-174; the fork pool becomes a thread pool:
    each worker waits on file reads and the device, and torch ops may be
    issued from several threads)."""
    plumes = list(itertools.chain.from_iterable(
        _dict_reader_plus_update(f, {minppmm_key: get_minppmm_from_fname(f)})
        for f in flist))
    worker = partial(process_plume, winds_dir, fill=fill, ext=ext,
                     station_fetch=station_fetch, device=device)
    if nprocs > 1:
        with ThreadPoolExecutor(max_workers=nprocs) as pool:
            plumes_ext = list(pool.map(worker, plumes))
    else:
        plumes_ext = [worker(p) for p in plumes]
    if plumes_ext:
        sort_by_key = list(plumes_ext[0].keys())[0]
        plumes_ext = sorted(plumes_ext, key=lambda d: d[sort_by_key])
    return plumes_ext


def insert_plumes_in_file(plumes, fname, sort_by_key=None, logger=None):
    """Merge plumes into the output CSV: append to any existing rows,
    back up the original to .bak, sort, write
    (reference: msf_flow.py:176-267)."""
    if not plumes:
        if logger:
            logger.warning("Skipped insertion because plume list was empty")
        return
    if os.path.isfile(fname):
        with open(fname) as fin:
            plumes = list(DictReader(fin)) + plumes
        copyfile(fname, fname + ".bak")
        if logger:
            logger.critical(f"Original plume file backed up to {fname}.bak")
    if sort_by_key is not None and sort_by_key in plumes[0]:
        plumes = sorted(plumes, key=lambda d: d[sort_by_key])
    field_names = list(plumes[0].keys())
    outdir = os.path.dirname(fname)
    if outdir and not os.path.isdir(outdir):
        os.makedirs(outdir)
    with open(fname, "w", newline="") as fout:
        writer = DictWriter(fout, fieldnames=field_names)
        writer.writeheader()
        for plume in plumes:
            try:
                writer.writerow(plume)
            except ValueError:
                if logger:
                    logger.warning(f"Could not write plume: {plume}")


def build_parser():
    p = argparse.ArgumentParser(
        description="MSF plume workflow (PyTorch/CUDA): plume lists -> wind "
                    "statistics and emission rates -> merged list")
    p.add_argument("-p", "--plume_dir", required=False,
                   help="directory watched for new plume CSVs")
    p.add_argument("-w", "--winds_dir", required=True,
                   help="directory of wind subdirs (hrrr/, rtma/, ...)")
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("-n", "--nprocs", type=int, default=1)
    p.add_argument("--fill", default=None)
    p.add_argument("--regex", default=r".*minppmm\d+.*\.csv$")
    p.add_argument("--flmode", default=None,
                   help="process a single plume file instead of watching a "
                        "directory")
    p.add_argument("--force", action="store_true",
                   help="treat all matching files as new")
    p.add_argument("--wind-ext", default=".grib2", choices=[".grib2", ".npz"])
    p.add_argument("--store", default=None,
                   help="object-store URI (s3://bucket/prefix or a local "
                        "dir): plume lists matching --regex are fetched from "
                        "it and the merged output is uploaded back — the "
                        "reference's AWS mode (msf_flow.py:286-348, :254-267)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the nearest-cell search (cuda raises "
                        "without a card)")
    return p


def main(argv=None):
    """CLI (reference: msf_flow.py:269-368)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    logger = init_logger("msf_flow")
    store = None
    if args.store:
        from .objectstore import open_store
        store, _ = open_store(args.store)
        staging = tempfile.mkdtemp(prefix="msfflow_")
        pat = re.compile(args.regex)
        flist = []
        for key in store.list():
            if pat.search(os.path.basename(key)):
                flist.append(store.get(
                    key, os.path.join(staging, os.path.basename(key))))
        # resume the existing merged output (.bak semantics preserved)
        outkey = os.path.basename(args.outfile)
        if store.exists(outkey) and not os.path.isfile(args.outfile):
            store.get(outkey, args.outfile)
    elif args.flmode:
        flist = [args.flmode]
    else:
        watcher = DirWatcher(args.plume_dir, force=args.force,
                             regex=args.regex)
        flist = watcher.whats_new_local()
    if not flist:
        logger.warning("no new plume files")
        return 0
    plumes = process_plumes(flist, args.winds_dir, nprocs=args.nprocs,
                            fill=args.fill, ext=args.wind_ext, device=dev)
    insert_plumes_in_file(plumes, args.outfile, sort_by_key="Candidate ID",
                          logger=logger)
    if store is not None:
        store.put(args.outfile, os.path.basename(args.outfile))
        logger.info("uploaded %s to the object store", args.outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
