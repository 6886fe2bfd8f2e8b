"""COVID systematics validation against a curated flightline list.

Port of the JAX package's ``triage/systematics.py`` (reference:
triage/COVID/COVID_systematics_ID_Deliver.py): 280 hand-labeled
flightlines with severity 0 / 0.5 / 1 / 2; the detector's 0/1 flags are
scored strict (0 vs nonzero severity) and loose (<1 vs >=1), plus
per-severity true-positive counts — the repo's only regression oracle
(expected output checked into COVID_Example_Output.txt).

The detector flags flightlines where the column-median profile deviates
from its rolling median (COVID_systematics_ID_Deliver.py:247-256):

    hold = count( med - rollmed_3(med) > nsigma * meanAD(med) )

where ``meanAD`` is the mean absolute deviation (pandas ``Series.mad()``,
which the validator uses). A flightline is flagged when hold >= 1 (the
validator rescales any count to 1, :258-262). It is host numpy and
pandas; this module imports no torch, so the oracle's report does not
need it (``triage.profile`` re-exports the detector).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

__all__ = ["load_systematics_list", "validate_systematics", "confusion_report",
           "systematics_count", "flag_systematics"]


def _mean_abs_dev(x):
    x = np.asarray(x, np.float64)
    x = x[np.isfinite(x)]
    return np.abs(x - x.mean()).mean() if x.size else np.nan


def systematics_count(med, nadj_col: int = 3, nsigma_col: float = 3.0):
    """Number of columns whose median exceeds the rolling median by
    nsigma * meanAD (reference: COVID_systematics_ID_Deliver.py:247-256).
    Rolling ends are NaN (centered window), matching pandas."""
    ser = pd.Series(np.asarray(med, np.float64))
    roll = ser.rolling(nadj_col, center=True).median()
    sigma = _mean_abs_dev(ser.values)
    return int(np.count_nonzero((ser - roll).values > nsigma_col * sigma))


def flag_systematics(med, **kwargs) -> int:
    """0/1 flag (the validator rescales counts > 1 to 1,
    COVID_systematics_ID_Deliver.py:258-262)."""
    return 1 if systematics_count(med, **kwargs) >= 1 else 0


def load_systematics_list(path):
    """Parse the curated list: lines of '<flightline>, <severity>'
    (severity in {0, 0.5, 1, 2}; the real COVID_systematics.txt is
    comma-separated — whitespace accepted too)."""
    names, sev = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = [p.strip() for p in
                     (line.split(",") if "," in line else line.split())]
            if len(parts) >= 2:
                names.append(parts[0])
                sev.append(float(parts[1]))
    return names, np.asarray(sev)


def validate_systematics(names, severities, stats_dir,
                         med_column="med", nadj_col=3, nsigma_col=3.0):
    """Run the detector over each flightline's column-stats CSV and score
    against curated severities (reference:
    COVID_systematics_ID_Deliver.py:184-351). Missing CSVs raise, like the
    reference's file-count check (:184-191)."""
    result = np.zeros(len(names))
    for i, name in enumerate(names):
        csvf = os.path.join(stats_dir, name + "_column_stats.csv")
        if not os.path.exists(csvf):
            raise FileNotFoundError(csvf)
        df = pd.read_csv(csvf)
        med = df[med_column].values if med_column in df else df["avg"].values
        result[i] = flag_systematics(med, nadj_col=nadj_col,
                                     nsigma_col=nsigma_col)
    return confusion_report(np.asarray(severities), result)


def confusion_report(systematics, result):
    """Strict/loose confusion counts + per-severity TPs (reference:
    COVID_systematics_ID_Deliver.py:266-351)."""
    rep = {
        # strict: exactly-0 severity vs any detector flag
        "strict": {
            "none_tp": int(((systematics == 0) & (result == 0)).sum()),
            "none_fp": int(((systematics == 0) & (result != 0)).sum()),
            "any_tp": int(((systematics != 0) & (result != 0)).sum()),
            "any_fn": int(((systematics != 0) & (result == 0)).sum()),
        },
        # loose: severity < 1 (incl. maybes) vs flag
        "loose": {
            "none_tp": int(((systematics < 1) & (result < 1)).sum()),
            "none_fp": int(((systematics < 1) & (result >= 1)).sum()),
            "any_tp": int(((systematics >= 1) & (result >= 1)).sum()),
            "any_fn": int(((systematics >= 1) & (result < 1)).sum()),
        },
        "strong_tp": int(((systematics == 2) & (result > 0)).sum()),
        "weak_tp": int(((systematics == 1) & (result > 0)).sum()),
        "maybe_tp": int(((systematics == 0.5) & (result < 1)).sum()),
    }
    return rep
