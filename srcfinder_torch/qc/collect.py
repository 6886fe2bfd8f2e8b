"""Post-campaign QC label merge: multi-user consensus -> training labels.

Port of the JAX package's ``qc/collect.py`` (host pandas, as there).
Reference (cmftagger/collect_qcdata.py): gather all users' submitted
per-flightline and per-candidate CSVs, accept/reject flightlines from
configured flag rules (with interactive conflict resolution), then run
the per-candidate consensus state machine:

    any Reject                      -> Reject
    all ambiguous                   -> Ambiguous
    positive AND negative present   -> Ambiguous
    any ambiguous + pos or neg      -> Ambiguous
    all negative                    -> False Enhancement
    all positive                    -> Super Plume if present else Plume

assigning class -1/0/1 and TP/FP eval, finally emitting the filtered
``*_cid_filt_nodup_norej_noamb`` label set that seeds CNN training.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pandas as pd

from .labels import (LIDCOL, CIDCOL, LABCOL, CLSCOL, UIDCOL, EVALCOL,
                     KEEPLAB, REJLAB, PLUMELAB, SUPERLAB, FALSELAB, AMBLAB,
                     DUPLAB, POSLABS, NEGLABS, AMBLABS)

__all__ = ["gather_submitted", "filter_flightlines", "consensus_label",
           "consensus_candidates", "collect_qcdata"]


def gather_submitted(output_dir, users=None):
    """Collect all users' submitted ``*_{cid,lid}.csv``
    (reference: collect_qcdata.py:69-93). Layout:
    output_dir/<user>/submitted/<image>_{cid,lid}.csv with a 'User ID'
    column added."""
    cid_frames, lid_frames = [], []
    userdirs = sorted(glob.glob(os.path.join(output_dir, "*")))
    for ud in userdirs:
        user = os.path.basename(ud)
        if users is not None and user not in users:
            continue
        for f in sorted(glob.glob(os.path.join(ud, "submitted", "*_cid.csv"))):
            df = pd.read_csv(f)
            df[UIDCOL] = user
            cid_frames.append(df)
        for f in sorted(glob.glob(os.path.join(ud, "submitted", "*_lid.csv"))):
            df = pd.read_csv(f)
            df[UIDCOL] = user
            lid_frames.append(df)
    cid = pd.concat(cid_frames, ignore_index=True) if cid_frames else \
        pd.DataFrame(columns=[LIDCOL, CIDCOL, LABCOL, UIDCOL])
    lid = pd.concat(lid_frames, ignore_index=True) if lid_frames else \
        pd.DataFrame(columns=[LIDCOL, UIDCOL])
    return cid, lid


def filter_flightlines(liddf, lidfilters, resolver=None):
    """Accept/reject each flightline from per-flag accept/reject
    vocabularies (reference: collect_qcdata.py:151-203; config
    cmftagger/config/lidfilters.json). ``resolver(lid, conflict_df)``
    replaces the reference's interactive raw_input and must return
    'y'/'n'/'m' (default: ambiguous)."""
    liddf = liddf.copy()
    labels = np.array([KEEPLAB] * len(liddf), dtype=object)
    for col in liddf:
        if col in (LIDCOL, UIDCOL) or col not in lidfilters:
            continue
        vals = liddf[col].values
        accept = np.isin(vals, lidfilters[col]["accept"])
        reject = np.isin(vals, lidfilters[col]["reject"])
        assert (accept | reject).all(), f"unmapped values in {col}"
        labels[reject] = col
    labels[labels != KEEPLAB] = REJLAB
    liddf[LABCOL] = labels

    # conflicting labels among users for the same flightline
    uniqcols = [c for c in liddf.columns if c != UIDCOL]
    uniqrows = liddf.loc[~liddf.duplicated(keep=False, subset=uniqcols)]
    liddups = uniqrows.loc[uniqrows.duplicated(keep=False, subset=LIDCOL)]
    for lid, group in liddups.groupby(LIDCOL):
        if len(np.unique(group[LABCOL].values)) == 1:
            continue
        ans = (resolver(lid, group) if resolver else "m").lower()
        mask = liddf[LIDCOL].values == lid
        if ans.startswith("y"):
            liddf.loc[mask, LABCOL] = REJLAB
        elif ans.startswith("n"):
            liddf.loc[mask, LABCOL] = KEEPLAB
        else:
            liddf.loc[mask, LABCOL] = AMBLAB
    return liddf


def consensus_label(cidlabs):
    """Resolve one candidate's multi-user labels
    (reference: collect_qcdata.py:226-283)."""
    cidlabs = np.unique(np.asarray(cidlabs, dtype=object))
    if len(cidlabs) == 1:
        return cidlabs[0]
    rej = cidlabs == REJLAB
    amb = np.isin(cidlabs, AMBLABS)
    pos = np.isin(cidlabs, POSLABS)
    neg = np.isin(cidlabs, NEGLABS)
    if rej.any():
        return REJLAB
    if amb.all():
        return AMBLAB
    if neg.any() and pos.any():
        return AMBLAB
    if amb.any():
        return AMBLAB
    if neg.all():
        return FALSELAB
    if pos.all():
        return SUPERLAB if SUPERLAB in cidlabs else PLUMELAB
    return AMBLAB


def consensus_candidates(ciddf, lid_reject=()):
    """Apply the consensus machine per (lid, cid), assign class -1/0/1 and
    TP/FP eval (reference: collect_qcdata.py:212-311)."""
    ciddf = ciddf.copy()
    if CLSCOL not in ciddf:
        ciddf[CLSCOL] = 0
    if EVALCOL not in ciddf:
        ciddf[EVALCOL] = ""
    ciddf.loc[np.isin(ciddf[LIDCOL].values, list(lid_reject)),
              LABCOL] = REJLAB
    for (lid, cid), group in ciddf.groupby([LIDCOL, CIDCOL]):
        uselab = consensus_label(group[LABCOL].values)
        mask = ((ciddf[LIDCOL].values == lid)
                & (ciddf[CIDCOL].values == cid))
        clslab = 0
        if uselab in NEGLABS:
            clslab = -1
            ciddf.loc[mask, EVALCOL] = "FP"
        elif uselab in POSLABS:
            clslab = 1
            ciddf.loc[mask, EVALCOL] = "TP"
        ciddf.loc[mask, LABCOL] = uselab
        ciddf.loc[mask, CLSCOL] = clslab
    return ciddf


def collect_qcdata(output_dir, lidfilters, outprefix, users=None,
                   resolver=None):
    """Full merge: gather -> flightline filter -> candidate consensus ->
    filtered label sets (reference: collect_qcdata.py:324-341 emits
    *_cid_filt, *_cid_filt_nodup, *_cid_filt_nodup_norej,
    *_cid_filt_nodup_norej_noamb)."""
    ciddf, liddf = gather_submitted(output_dir, users)
    liddf = filter_flightlines(liddf, lidfilters, resolver)
    liddf.to_csv(outprefix + "_lid_filt.csv", index=False)
    lid_reject = liddf.loc[liddf[LABCOL].values == REJLAB, LIDCOL].values

    ciddf = consensus_candidates(ciddf, lid_reject)
    ciddf.to_csv(outprefix + "_cid_filt.csv", index=False)

    nd = ~ciddf.duplicated(keep="first", subset=[LIDCOL, CIDCOL])
    nd &= ciddf[LABCOL].values != DUPLAB
    ciddf = ciddf.loc[nd]
    ciddf.to_csv(outprefix + "_cid_filt_nodup.csv", index=False)

    ciddf = ciddf.loc[ciddf[LABCOL].values != REJLAB]
    ciddf.to_csv(outprefix + "_cid_filt_nodup_norej.csv", index=False)

    ciddf = ciddf.loc[~np.isin(ciddf[LABCOL].values, AMBLABS)]
    ciddf.to_csv(outprefix + "_cid_filt_nodup_norej_noamb.csv", index=False)
    return ciddf, liddf
