"""COVID systematics oracle harness — runs the reference's only
regression oracle end to end on real data.

Port of the JAX package's ``triage/covid.py`` (reference:
triage/COVID/COVID_systematics_ID_Deliver.py): reads the curated
280-flightline severity list (COVID_systematics.txt, severities
0/0.5/1/2), loads each flightline's robust column-stats CSV (produced by
triage/cmf_profile.py), flags systematics via the rolling-median test,
and prints strict/loose confusion statistics; the expected output is
checked into COVID_Example_Output.txt (strict TP=98/FP=22).

    python -m srcfinder_torch covid-oracle CURATED_TXT --stats-dir STATS \\
        [--cmf-dir CMFS] [--expected COVID_Example_Output.txt] \\
        [--device cuda|cpu]

- missing column-stats CSVs are REGENERATED from the real CMFs in
  ``--cmf-dir`` with the same robust profile the reference uses
  (triage.profile.summarize_cmf, npix/med/mad/p05/p95), on ``--device``
  (the card by default; it raises without one);
- the report is printed in the reference's exact textual format so it
  diffs cleanly against COVID_Example_Output.txt;
- ``--expected`` parses the reference output file and exits nonzero on
  any count mismatch.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from .systematics import load_systematics_list, validate_systematics

__all__ = ["load_curated_list", "ensure_profiles", "format_report",
           "parse_expected", "run_covid_oracle", "main", "_parse_counts"]

#: the curated severity list: the real file is comma-separated
#: ('ang..._img, 2', COVID_systematics.txt); whitespace-separated lines
#: are accepted too
load_curated_list = load_systematics_list


def _find_stats_csv(stats_dir, name):
    """The reference globs ``ang*_clip_column_stats.csv``
    (COVID_systematics_ID_Deliver.py:144) — accept both the _clip and
    plain spellings."""
    for cand in (os.path.join(stats_dir, name + "_clip_column_stats.csv"),
                 os.path.join(stats_dir, name + "_column_stats.csv")):
        if os.path.isfile(cand):
            return cand
    return None


def ensure_profiles(names, stats_dir, cmf_dir=None, progress=print,
                    device="cuda"):
    """Regenerate any missing robust column-stats CSV from the real CMF
    (idempotent — existing CSVs are kept, like cmf_profile.py:101-103).
    The column statistics run on ``device`` ("cuda", raising without a
    card, or "cpu")."""
    os.makedirs(stats_dir, exist_ok=True)
    missing = []
    for name in names:
        if _find_stats_csv(stats_dir, name):
            continue
        if cmf_dir is None:
            missing.append(name)
            continue
        cands = (glob.glob(os.path.join(cmf_dir, name)) +
                 glob.glob(os.path.join(cmf_dir, name + "_clip")) +
                 glob.glob(os.path.join(cmf_dir, "**", name),
                           recursive=True))
        cands = [c for c in cands if not c.endswith(".hdr")]
        if not cands:
            missing.append(name)
            continue
        # the device module (torch) loads only when a CMF is profiled
        from .profile import summarize_cmf
        progress(f"profiling {name}")
        summarize_cmf(cands[0], outdir=stats_dir, use_robust_stats=True,
                      device=device)
    if missing:
        raise FileNotFoundError(
            f"{len(missing)} flightlines have neither a column-stats CSV "
            f"in {stats_dir} nor a CMF to profile (first: {missing[0]})")


def format_report(severities, report, curated_name="COVID_systematics.txt"):
    """The reference's exact printout (COVID_systematics_ID_Deliver.py:
    118-133, 266-351 / COVID_Example_Output.txt) for a clean diff."""
    sev = np.asarray(severities)
    s, lo = report["strict"], report["loose"]
    lines = [
        f"Reading:  {curated_name}",
        "",
        "***COVID RAW STATISTICS***",
        f"       Total Files = {len(sev):.0f}",
        f"    No Systematics = {(sev == 0).sum():.0f}",
        f" Maybe Systematics = {(sev == 0.5).sum():.0f}",
        f"  Weak Systematics = {(sev == 1.0).sum():.0f}",
        f"Strong Systematics = {(sev == 2.0).sum():.0f}",
        "*************************",
        "",
        f"Number of Files:  {len(sev)}",
        "",
        "***STRICT COVID TEST STATISTICS***",
        f"No Systematics (True Positive) = {s['none_tp']:.0f}",
        f"No Systematics (False Positive) = {s['none_fp']:.0f}",
        f"Any Systematics (False Positive) = {s['any_fn']:.0f}",
        f"Any Systematics (True Positive) = {s['any_tp']:.0f}",
        "",
        "***LOOSE (INCLUDING MAYBES) COVID TEST STATISTICS***",
        f"No Systematics (True Positive) = {lo['none_tp']:.0f}",
        f"No Systematics (False Positive) = {lo['none_fp']:.0f}",
        f"Any Systematics (False Positive) = {lo['any_fn']:.0f}",
        f"Any Systematics (True Positive) = {lo['any_tp']:.0f}",
        "",
        "******",
        f"Strong Systematics (True Positive) = {report['strong_tp']:.0f}",
        f"Weak Systematics (True Positive) = {report['weak_tp']:.0f}",
        f"Maybe Systematics (True Positive) = {report['maybe_tp']:.0f}",
        "",
        "",
        "Successful Completion",
        "",
    ]
    return "\n".join(lines)


def _parse_counts(lines):
    out = {}
    section = ""
    for line in lines:
        line = line.strip()
        if line.startswith("***"):
            section = line.strip("*")
            continue
        m = re.match(r"(.+?)\s*=\s*(-?\d+)$", line)
        if m:
            out[(section, m.group(1).strip())] = int(m.group(2))
    return out


def parse_expected(path):
    """Pull every '<label> = <count>' line from a reference output file
    (COVID_Example_Output.txt) into {(section, label): count}."""
    with open(path) as f:
        return _parse_counts(f)


def run_covid_oracle(curated, stats_dir, cmf_dir=None, nadj_col=3,
                     nsigma_col=3.0, progress=print, device="cuda"):
    names, sev = load_curated_list(curated)
    ensure_profiles(names, stats_dir, cmf_dir, progress=progress,
                    device=device)
    # validate_systematics expects <name>_column_stats.csv; map the
    # reference's _clip spelling through a suffix search
    report = validate_systematics(
        [os.path.basename(_find_stats_csv(stats_dir, n))
         .replace("_column_stats.csv", "") for n in names],
        sev, stats_dir, nadj_col=nadj_col, nsigma_col=nsigma_col)
    text = format_report(sev, report,
                         curated_name=os.path.basename(curated))
    return report, text


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="COVID systematics oracle (srcfinder)")
    p.add_argument("curated", help="COVID_systematics.txt")
    p.add_argument("--stats-dir", required=True,
                   help="directory of (or for) *_column_stats.csv")
    p.add_argument("--cmf-dir", default=None,
                   help="real CMF images to profile when CSVs are missing")
    p.add_argument("--expected", default=None,
                   help="reference output (COVID_Example_Output.txt) to "
                        "verify counts against")
    p.add_argument("--nadj-col", type=int, default=3)
    p.add_argument("--nsigma-col", type=float, default=3.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the column statistics of regenerated "
                        "profiles (cuda raises without a card)")
    args = p.parse_args(argv)

    report, text = run_covid_oracle(args.curated, args.stats_dir,
                                    args.cmf_dir, args.nadj_col,
                                    args.nsigma_col, device=args.device)
    print(text)
    if args.expected:
        want = parse_expected(args.expected)
        got = _parse_counts(text.splitlines())
        bad = {k: (v, got.get(k)) for k, v in want.items()
               if got.get(k) != v}
        if bad:
            for k, (w, g) in bad.items():
                print(f"MISMATCH {k}: expected {w}, got {g}")
            return 1
        print("ALL COUNTS MATCH the expected reference output")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
