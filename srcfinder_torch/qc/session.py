"""Headless QC labeling session: assignment, autosave, submit/reset.

Port of the JAX package's ``qc/session.py``: the same state machine, the
same files byte for byte and the same log text.

Reference (cmftagger/cmftagger.py): a per-user Panel/Bokeh web app with
flightline assignment + todo/done tracking (:292-346), per-user CSV
autosave (:618-664) and a submit/reset lifecycle into
``output/<user>/submitted/``. The interactive HoloViews UI depends on
bokeh/panel/datashader (not present here); this module provides the same
session state machine headless so labels can be produced/consumed by any
front end, plus the ring-buffer log the app shows (circular_buffer.py).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from collections import deque

import pandas as pd

from .labels import LIDCOL, CIDCOL, LABCOL, LATCOL, LONCOL, next_cid, cmff_to_lid

__all__ = ["CircularBuffer", "QcSession", "load_settings"]


class CircularBuffer:
    """Fixed-size ring buffer for the app log panel
    (reference: cmftagger/circular_buffer.py:4-68)."""

    def __init__(self, maxlen: int = 100):
        self._buf = deque(maxlen=maxlen)

    def append(self, item):
        self._buf.append(item)

    def __len__(self):
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def __getitem__(self, i):
        return list(self._buf)[i]

    def text(self):
        return "\n".join(str(x) for x in self._buf)


def load_settings(path):
    """Campaign settings JSON (reference: cmftagger/config/settings.json;
    note the reference's settings_covid.json has a syntax error — this
    loader raises on such files rather than half-parsing)."""
    with open(path) as f:
        return json.load(f)


class QcSession:
    """Per-user labeling session over a campaign's CMF products."""

    def __init__(self, user: str, datapath: str, output_dir: str,
                 file_regex: str = r".*(_cmf_|_ch4mf_).*img$", log_len: int = 100):
        self.user = user
        self.datapath = datapath
        self.output_dir = output_dir
        self.userdir = os.path.join(output_dir, user)
        self.submitted_dir = os.path.join(self.userdir, "submitted")
        os.makedirs(self.submitted_dir, exist_ok=True)
        self.file_regex = file_regex
        self.log = CircularBuffer(log_len)
        self.update_datafiles()

    # ---- discovery / assignment (reference: cmftagger.py:292-346) ----
    def update_datafiles(self):
        import re
        pat = re.compile(self.file_regex)
        self.datafiles = sorted(
            f for f in glob.glob(os.path.join(self.datapath, "*"))
            if pat.search(os.path.basename(f)))
        done = {os.path.basename(f).replace("_cid.csv", "")
                for f in glob.glob(os.path.join(self.submitted_dir,
                                                "*_cid.csv"))}
        self.done = [f for f in self.datafiles
                     if os.path.basename(f) in done]
        self.todo = [f for f in self.datafiles
                     if os.path.basename(f) not in done]
        self.log.append(f"{len(self.todo)} todo, {len(self.done)} done")
        return self.todo

    # ---- candidate table management -----------------------------------
    def _cid_csv(self, cmff, submitted=False):
        base = os.path.basename(cmff)
        d = self.submitted_dir if submitted else self.userdir
        return os.path.join(d, base + "_cid.csv")

    def _lid_csv(self, cmff, submitted=False):
        base = os.path.basename(cmff)
        d = self.submitted_dir if submitted else self.userdir
        return os.path.join(d, base + "_lid.csv")

    def load_candidates(self, cmff, plumedf=None):
        """Load the working candidate table: autosaved state if present,
        else the campaign plume list subset for this flightline."""
        csvf = self._cid_csv(cmff)
        if os.path.isfile(csvf):
            return pd.read_csv(csvf, dtype={CIDCOL: str})
        lid = cmff_to_lid(cmff)
        if plumedf is not None:
            sub = plumedf.loc[plumedf[LIDCOL] == lid].copy()
            sub[CIDCOL] = [str(c).split("-")[-1] for c in sub[CIDCOL]]
            return sub.reset_index(drop=True)
        return pd.DataFrame(columns=[LIDCOL, CIDCOL, LATCOL, LONCOL,
                                     LABCOL])

    def add_candidate(self, ciddf, cmff, lat, lon, label):
        """Interactive candidate add (the DoubleTap stream's action,
        reference: cmftagger.py:711-755)."""
        cid = next_cid(label, ciddf) if len(ciddf) else "A"
        row = {LIDCOL: cmff_to_lid(cmff), CIDCOL: cid, LATCOL: lat,
               LONCOL: lon, LABCOL: label}
        ciddf = pd.concat([ciddf, pd.DataFrame([row])], ignore_index=True)
        self.log.append(f"added candidate {cid} ({label})")
        return ciddf

    def delete_candidate(self, ciddf, cid):
        """(reference: cmftagger.py:396-430)"""
        keep = ciddf[CIDCOL].astype(str) != str(cid)
        self.log.append(f"deleted candidate {cid}")
        return ciddf.loc[keep].reset_index(drop=True)

    def autosave(self, cmff, ciddf, lid_flags=None):
        """Autosave per-user working CSVs on every table edit
        (reference: cmftagger.py:618-664)."""
        ciddf.to_csv(self._cid_csv(cmff), index=False)
        if lid_flags is not None:
            self.save_flags(cmff, lid_flags)
        return self._cid_csv(cmff)

    # ---- flightline QC flags (reference: cmftagger.py:471-532) ---------
    def load_flags(self, cmff) -> dict:
        """Per-flightline flag values from the autosaved (or submitted)
        ``*_lid.csv`` — one row per flightline, columns = flag names
        (the format collect.gather_submitted consumes)."""
        for f in (self._lid_csv(cmff), self._lid_csv(cmff, submitted=True)):
            if os.path.isfile(f):
                df = pd.read_csv(f)
                row = df.iloc[0].to_dict()
                row.pop(LIDCOL, None)
                return {k: ("" if pd.isna(v) else str(v))
                        for k, v in row.items()}
        return {}

    def save_flags(self, cmff, flags: dict):
        """Write the one-row flightline flag CSV."""
        row = {LIDCOL: cmff_to_lid(cmff), **flags}
        pd.DataFrame([row]).to_csv(self._lid_csv(cmff), index=False)
        self.log.append(f"flags saved for {os.path.basename(cmff)}")
        return self._lid_csv(cmff)

    def submit(self, cmff):
        """Move autosaved state into submitted/ (reference:
        cmftagger.py:534-590)."""
        moved = []
        for f in (self._cid_csv(cmff), self._lid_csv(cmff)):
            if os.path.isfile(f):
                dst = os.path.join(self.submitted_dir, os.path.basename(f))
                shutil.copyfile(f, dst)
                moved.append(dst)
        self.update_datafiles()
        self.log.append(f"submitted {os.path.basename(cmff)}")
        return moved

    def reset(self, cmff):
        """Discard autosaved (unsubmitted) state."""
        for f in (self._cid_csv(cmff), self._lid_csv(cmff)):
            if os.path.isfile(f):
                os.remove(f)
        self.log.append(f"reset {os.path.basename(cmff)}")
