"""Comparisons that decide ``correct``: each gives one number, held to its
limit from the cell's workload file."""

from __future__ import annotations

import math

import numpy as np


def max_rel_gap(got, want, valid):
    """max |got - want| over ``valid`` / max |want| over ``valid``; inf where
    the nodata masks differ or a value is not finite."""
    if got.shape != want.shape:
        return math.inf
    g, w = np.asarray(got, np.float64)[valid], np.asarray(want, np.float64)[valid]
    if g.size == 0 or not np.isfinite(g).all():
        return math.inf
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))


def table_gap(got_rows, want_rows):
    """Largest gap between two tables of rows: text must be equal, numbers
    are compared by |a - b| / max(|b|, 1), NaN only against NaN; a table of
    another length, or a cell that differs in kind, is inf."""
    if len(got_rows) != len(want_rows):
        return math.inf
    gap = 0.0
    for g_row, w_row in zip(got_rows, want_rows):
        if len(g_row) != len(w_row):
            return math.inf
        for a, b in zip(g_row, w_row):
            if isinstance(b, str) or isinstance(a, str):
                if str(a) != str(b):
                    return math.inf
                continue
            a, b = float(a), float(b)
            if math.isnan(a) or math.isnan(b):
                if not (math.isnan(a) and math.isnan(b)):
                    return math.inf
                continue
            gap = max(gap, abs(a - b) / max(abs(b), 1.0))
    return gap


def verdict(readings: dict, limits: dict) -> list:
    """[{name, value, limit}] in the order of ``limits``; a reading that is
    missing counts as inf."""
    return [dict(name=k, value=readings.get(k, math.inf), limit=v) for k, v in limits.items()]


def passed(rows) -> bool:
    return all(r["value"] <= r["limit"] for r in rows)
