"""Config-driven wind-granule harvester + fan-out + quality check.

Reference (msf_flow/harvester/): YAML dataset configs with
%Y%m%d%H%M%S-templated URL/path patterns and a time resolution, a
date-range resolver (-s/-e/-n), a download loop that skips already-present
granules, a Lambda fan-out that splits a day into per-dataset windows
(invoke_harvester.py — the repo's "distributed scheduler"), and a
post-download GRIB validation with email alerting
(wind_quality_check.py).

This environment has zero egress, so the fetcher is injectable (tests
pass a local-copy fetcher); the AWS S3/Lambda plumbing maps onto the
local work-queue in :mod:`srcfinder_torch.flow.deploy`. The port's copy
of the JAX package's ``flow/harvester.py``.
"""

from __future__ import annotations

import os
from datetime import datetime, timedelta, timezone

__all__ = ["load_dataset_conf", "set_date_range", "replace_template",
           "time_setting_dict", "paths_generator", "harvest_date_range",
           "invoke_harvester_windows", "wind_quality_check"]


def load_dataset_conf(path: str) -> dict:
    """YAML dataset config {url_template, local_path_template, time_res}
    (reference: harvester/.cedas/dataset.yaml.template:29-32)."""
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def set_date_range(args: dict, date_fmt: str = "%Y%m%d", now=None):
    """Resolve (start, end) from start_date/end_date/num_days
    (reference: harvest.py:51-126). Raises ValueError instead of
    sys.exit()."""
    utcnow = now or datetime.now(timezone.utc)
    utc_today = datetime(utcnow.year, utcnow.month, utcnow.day,
                         tzinfo=timezone.utc)
    start_date = end_date = None
    if args.get("start_date"):
        d = datetime.strptime(args["start_date"], date_fmt)
        start_date = datetime(d.year, d.month, d.day, d.hour,
                              tzinfo=timezone.utc)
        if start_date > utc_today:
            raise ValueError("Cannot specify a start date in the future")
    if args.get("end_date"):
        d = datetime.strptime(args["end_date"], date_fmt)
        end_date = datetime(d.year, d.month, d.day, d.hour, 59, 59,
                            tzinfo=timezone.utc)
        if start_date and end_date < start_date:
            raise ValueError("End date cannot be before start date.")
    if args.get("num_days") is not None and args["num_days"] < 1:
        raise ValueError("Cannot specify less than 1 days to harvest")

    if args.get("num_days"):
        ndays = timedelta(days=args["num_days"]) - timedelta(seconds=1)
        if start_date and end_date:
            raise ValueError("Cannot specify all 3 of start date, end date "
                             "and number of days")
        if start_date:
            end_date = start_date + ndays
        elif end_date:
            start_date = end_date - ndays
        else:
            end_date = datetime(utc_today.year, utc_today.month,
                                utc_today.day, 23, 59, 59,
                                tzinfo=timezone.utc)
            start_date = end_date - ndays
    else:
        if start_date and end_date:
            pass
        elif start_date:
            end_date = datetime(utc_today.year, utc_today.month,
                                utc_today.day, 23, 59, 59,
                                tzinfo=timezone.utc)
        elif end_date:
            start_date = end_date
        else:
            start_date = utc_today
            end_date = datetime(utc_today.year, utc_today.month,
                                utc_today.day, 23, 59, 59,
                                tzinfo=timezone.utc)
    return start_date, end_date


def replace_template(template: str, cur_date) -> str:
    """(reference: harvest.py:128-148)"""
    trans = {"%Y": f"{cur_date.year:04d}", "%m": f"{cur_date.month:02d}",
             "%d": f"{cur_date.day:02d}", "%H": f"{cur_date.hour:02d}",
             "%M": f"{cur_date.minute:02d}", "%S": f"{cur_date.second:02d}"}
    out = template
    for k, v in trans.items():
        out = out.replace(k, v)
    return out


def time_setting_dict(time_str: str) -> dict:
    """'90s'/'3h'/'1d' -> timedelta kwargs (reference: harvest.py:150-167)."""
    units = {"s": "seconds", "m": "minutes", "h": "hours", "d": "days",
             "w": "weeks"}
    return {units[time_str[-1]]: int(time_str[:-1])}


def paths_generator(start_date, end_date, local_basedir, dataset_conf):
    """Yield (url, local_path, local_fname) per granule time
    (reference: harvest.py:169-192)."""
    step = timedelta(**time_setting_dict(dataset_conf["time_res"]))
    cur = start_date
    while cur <= end_date:
        url = replace_template(dataset_conf["url_template"], cur)
        rel = replace_template(dataset_conf["local_path_template"], cur)
        local_path = os.path.join(local_basedir, rel)
        yield url, local_path, os.path.basename(local_path)
        cur = cur + step


def _urllib_fetch(url, local_path):
    import urllib.request
    urllib.request.urlretrieve(url, local_path)


def harvest_date_range(start_date, end_date, local_basedir, dataset_conf,
                       fetcher=_urllib_fetch, logger=None):
    """Download granules in the range, skipping existing files (idempotent
    resume — reference: harvest.py:194-232 ``if not os.path.exists``).
    Per-item failures are logged and skipped, not raised."""
    done, failed = [], []
    for url, local_path, fname in paths_generator(start_date, end_date,
                                                  local_basedir,
                                                  dataset_conf):
        os.makedirs(os.path.dirname(local_path), exist_ok=True)
        if os.path.exists(local_path):
            continue
        try:
            fetcher(url, local_path)
            done.append(local_path)
            if logger:
                logger.warning(f"Downloaded {url} to {local_path}")
        except Exception:
            failed.append(url)
            if logger:
                logger.error(f"Unable to download {url}")
    return done, failed


def invoke_harvester_windows(day, datasets=("hrrr", "rtma")):
    """Split one day into per-dataset harvest windows — the role of the
    Lambda fan-out (reference: harvester/invoke_harvester.py:5-67:
    4-hour windows for HRRR, 1-hour for RTMA). Returns a list of
    (dataset, start, end) jobs to submit to any executor."""
    jobs = []
    base = datetime(day.year, day.month, day.day, tzinfo=timezone.utc)
    for ds in datasets:
        hours = 4 if "hrrr" in ds.lower() else 1
        t = base
        while t < base + timedelta(days=1):
            jobs.append((ds, t, t + timedelta(hours=hours)
                         - timedelta(seconds=1)))
            t += timedelta(hours=hours)
    return jobs


def wind_quality_check(path, alert=None):
    """Validate a wind granule by opening and reading it; on failure call
    ``alert(subject, message)`` (the reference emails via SES/mailx,
    wind_quality_check.py:30-135). Returns True when readable."""
    from .windgrid import read_wind_grid
    try:
        grid = read_wind_grid(path)
        ok = grid.u.size > 0 and grid.v.size > 0
    except Exception as e:
        ok = False
        err = str(e)
    if not ok and alert is not None:
        alert(f"Bad wind file {os.path.basename(path)}",
              f"Wind file {path} is empty or unreadable")
    return ok


def main(argv=None):
    """``srcfinder-harvest`` — the harvester CLI (reference flags:
    harvest.py:16-25 -ds/-b/-s/-e/-n)."""
    import argparse

    p = argparse.ArgumentParser(description="Config-driven wind-granule "
                                "harvester")
    p.add_argument("-c", "--config", required=True,
                   help="dataset YAML (url_template/local_path_template/"
                        "time_res)")
    p.add_argument("-b", "--data_basedir", default=".")
    p.add_argument("-s", "--start_date", default=None, help="YYYYMMDD")
    p.add_argument("-e", "--end_date", default=None, help="YYYYMMDD")
    p.add_argument("-n", "--num_days", type=int, default=None)
    args = p.parse_args(argv)

    conf = load_dataset_conf(args.config)
    dates = {"start_date": args.start_date, "end_date": args.end_date,
             "num_days": args.num_days}
    start, end = set_date_range(dates)
    done, failed = harvest_date_range(start, end, args.data_basedir, conf)
    print(f"[INFO] downloaded {len(done)}, failed {len(failed)}, "
          f"range {start}..{end}")
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
