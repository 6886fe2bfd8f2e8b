"""QC label taxonomy, candidate-id allocation, coordinate helpers.

(reference: cmftagger/util.py:41-96 taxonomy + canonical columns,
:130-150 ``next_cid``, :260-306 web-mercator transforms + ``cmf_plumes``,
:308-320 ``lid2uidassign``, :510-560 flag CSV round-trip). The port's
copy of the JAX package's ``qc/labels.py``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import pandas as pd

__all__ = [
    "CMFCOL", "EVALCOL", "LIDCOL", "CIDCOL", "LATCOL", "LONCOL", "LABCOL",
    "CLSCOL", "UIDCOL", "DONECOL", "ROWCOL", "COLCOL", "XCOL", "YCOL",
    "KEEPLAB", "REJLAB", "PLUMELAB", "SUPERLAB", "POSLABS", "ARTFLAB",
    "CLOUDLAB", "FALSELAB", "NEGLABS", "AMBLAB", "BGLAB", "DUPLAB",
    "AMBLABS",
    "classlabs", "next_cid", "lnglat_to_meters", "meters_to_lnglat",
    "cmff_to_lid", "lid2uidassign", "save_flag_csv", "load_flag_csv", "save_classlabs",
]

# canonical plume-list / QC columns (reference: util.py:44-66)
CMFCOL = "CMF Image"
EVALCOL = "True_pos/false_pos"
LIDCOL = "Line name"
CIDCOL = "Candidate ID"
LATCOL = "Plume Latitude (deg)"
LONCOL = "Plume Longitude (deg)"
LABCOL = "Label"
CLSCOL = "Class Label"
UIDCOL = "User ID"
DONECOL = "QC Completed"
ROWCOL = "Row"
COLCOL = "Col"
XCOL = "Web Mercator X (m)"
YCOL = "Web Mercator Y (m)"

KEEPLAB = "Accept"
REJLAB = "Reject"

# label vocabulary (reference: util.py:68-80)
PLUMELAB = "Plume"
SUPERLAB = "Super Plume"
POSLABS = [PLUMELAB, SUPERLAB]
ARTFLAB = "Artifact"
CLOUDLAB = "Cloud"
FALSELAB = "False Enhancement"
NEGLABS = [ARTFLAB, CLOUDLAB, FALSELAB]
AMBLAB = "Ambiguous"
BGLAB = "Background"
DUPLAB = "Duplicate"
AMBLABS = [AMBLAB, DUPLAB, BGLAB]


def save_classlabs(jsonoutf):
    """Write the positive/negative/ambiguous label vocabulary JSON
    (reference: util.py:86-95 ``save_classlabs``)."""
    import json
    with open(jsonoutf, "w") as fout:
        json.dump(OrderedDict(positive=POSLABS, negative=NEGLABS,
                              ambiguous=AMBLABS), fout)
    return jsonoutf


def classlabs(labvals, dtype=np.int8):
    """Labels -> binary class by the 'ends with plume' rule
    (reference: util.py:124-128)."""
    if dtype is str:
        return np.array([PLUMELAB if l.lower().endswith("plume")
                         else FALSELAB for l in labvals])
    return dtype([l.lower().endswith("plume") for l in labvals])


def next_cid(tgtlab, ciddf, byclass: bool = False):
    """Allocate the next candidate id: positive candidates get letters
    ('A', 'B', ...), numeric ids otherwise (reference: util.py:130-150)."""
    tgtcids = ciddf[CIDCOL].values
    tgtlabv = 1
    if byclass:
        labv = classlabs(np.r_[[tgtlab], ciddf[LABCOL].values])
        tgtlabv, labv = labv[0], labv[1:]
        tgtcids = tgtcids[labv == tgtlabv]
    if len(tgtcids) == 0:
        return "A" if tgtlabv == 1 else "1"
    tgtcids = np.array(tgtcids, dtype=str)
    maxcode = max(ord(cid) if len(cid) == 1 else int(cid)
                  for cid in tgtcids)
    if not byclass and maxcode < ord("A"):
        return "A"
    return chr(int(maxcode) + 1)


_R = 6378137.0


def lnglat_to_meters(lng, lat):
    """WGS-84 lon/lat -> Web Mercator meters (EPSG:3857)
    (reference: util.py:260-269, datashader convention)."""
    lng = np.asarray(lng, np.float64)
    lat = np.asarray(lat, np.float64)
    x = lng * (np.pi / 180) * _R
    y = _R * np.log(np.tan(np.pi / 4 + np.radians(lat) / 2))
    return x, y


def meters_to_lnglat(x, y):
    lng = np.asarray(x, np.float64) / _R / (np.pi / 180)
    lat = np.degrees(2 * np.arctan(np.exp(np.asarray(y) / _R)) - np.pi / 2)
    return lng, lat


def cmff_to_lid(cmff: str) -> str:
    """CMF filename -> flightline id (angYYYYMMDDtHHMMSS)."""
    return os.path.basename(str(cmff)).split("_")[0]


def lid2uidassign(plumedf, users, csvoutf="lid2uid_assign.csv", seed=None):
    """Randomly assign flightlines to users, balanced
    (reference: util.py:308-320)."""
    rng = np.random.default_rng(seed)
    lids = np.unique(plumedf[LIDCOL].values)
    nlids, nusers = len(lids), len(users)
    nulids = int(np.ceil(nlids / nusers))
    uids = []
    for uid in users:
        uids.extend([uid] * nulids)
    uids = rng.permutation(uids)[:nlids]
    df = pd.DataFrame(np.c_[lids, uids], columns=[LIDCOL, UIDCOL])
    df.to_csv(csvoutf, index=False)
    return df


def save_flag_csv(csvf, flags, flag_opts, usernotes: str = ""):
    """Per-flightline QC flag CSV (reference: util.py:547-554; the
    reference's round-trip assert calls load_csv with a missing argument
    — fixed here)."""
    csvout = [(flag.strip(), int(flag in flags)) for flag in flag_opts]
    usernotes = usernotes.replace('"', "")
    csvout.append(("notes", usernotes))
    df = pd.DataFrame(csvout, columns=["name", "value"])
    df.to_csv(csvf, index=False)
    back, _ = load_flag_csv(csvf, flag_opts)
    assert set(back) == set(f for f in flags if f in flag_opts)
    return csvf


def load_flag_csv(csvf, flag_opts):
    """(reference: util.py:531-545)"""
    df = pd.read_csv(csvf, dtype=str).set_index("name")
    notes = str(df.loc["notes", "value"]) if "notes" in df.index else ""
    keep = [f for f in flag_opts if f in df.index]
    user_flags = [f for f in keep if str(df.loc[f, "value"]) == "1"]
    return np.array(user_flags), notes
