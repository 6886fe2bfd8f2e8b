"""Salience map -> plume candidate list.

Reference (salience_predictions.py): threshold the saliency, label
connected components, compute per-region salience and CMF statistics,
georeference the CMF maximum, and emit the canonical plume-list
spreadsheet columns ("Candidate ID", "Line name", "Plume Latitude (deg)",
...). Port of the JAX package's ``detect/salience.py`` without the
per-candidate quicklook PDFs.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
from scipy import ndimage

from ..core.geo import sl2latlon
from ..core.morphology import findobj, imlabel
from ..core.stats import extrema, mad

__all__ = ["salience2detections", "save_detections", "DETECTION_COLUMNS"]

OUTHDR = (["detid", "lid", "detbbminr", "detbbmaxr", "detbbminc", "detbbmaxc"]
          + ["salmax", "salmin", "salmed", "salmad", "salmaxrow", "salmaxcol"]
          + ["salmaxlat", "salmaxlon"]
          + ["cmfmax", "cmfmin", "cmfmed", "cmfmad", "cmfmaxrow", "cmfmaxcol"]
          + ["cmfmaxlat", "cmfmaxlon"])

#: canonical plume-list columns (reference: salience_predictions.py:169-182)
DETECTION_COLUMNS = [
    "Candidate ID", "Line name",
    "Plume Latitude (deg)", "Plume Longitude (deg)",
    "CMF Min (ppmm)", "CMF Max (ppmm)", "CMF Median (ppmm)", "CMF MAD (ppmm)",
    "Salience Min (%)", "Salience Max (%)", "Salience Median (%)",
    "Salience MAD (%)",
]


def salience2detections(salimg, cmfimg, salthr, cmfthr, cmflid, cmfmap):
    """Connected salience regions -> per-candidate stats dataframe
    (reference: salience_predictions.py:25-150).

    salimg: (H, W) or (H, W, 2) saliency; cmfimg: (H, W, 4) RGB+CMF.
    """
    salimg = np.asarray(salimg)
    cmfimg = np.asarray(cmfimg)
    if cmfimg.ndim != 3 or cmfimg.shape[2] != 4:
        raise ValueError(f"cmfimg must be (H, W, 4), got {cmfimg.shape}")

    salpos = salimg[..., -1] if salimg.ndim == 3 else salimg
    if salimg.ndim == 3 and salimg.shape[-1] == 2:
        salpos = salpos / salimg.sum(axis=2)

    cmfrgb = cmfimg[..., :3]
    cmfdet = cmfimg[..., 3]
    nodata = cmfrgb[..., 0] == -9999
    cmfmask = cmfdet > cmfthr
    salmask = salpos > salthr
    salreg = imlabel(salmask)
    salobj = findobj(salreg)

    rows = []
    for ri, robj in enumerate(salobj):
        plab = ri + 1
        imin, imax = robj[0].start, robj[0].stop
        jmin, jmax = robj[1].start, robj[1].stop
        ndmask = ~nodata[robj]
        pmsk = (salreg[robj] == plab) & ndmask
        pimg = salpos[robj].copy()
        pimgm = pimg * pmsk
        ppix = pimg[pmsk]
        if ppix.size == 0:
            continue
        pmed = np.median(ppix)
        pmad = mad(ppix, medval=pmed)
        ppmn, ppmx = extrema(ppix)
        pmi, pmj = (np.int32(ndimage.center_of_mass(pimgm == ppmx))
                    + [imin, jmin])

        cmsk = cmfmask[robj] & pmsk
        cimg = cmfdet[robj].copy()
        cimgm = cimg * cmsk
        cpix = cimg[cmsk]
        if cpix.size == 0:
            # no CMF enhancement inside this salience region
            cpmn = cpmx = cmed = cmad = np.nan
            cmi, cmj = pmi, pmj
        else:
            cpmn, cpmx = extrema(cpix)
            cmed = np.median(cpix)
            cmad = mad(cpix, medval=cmed)
            cmi, cmj = (np.int32(ndimage.center_of_mass(cimgm == cpmx))
                        + [imin, jmin])

        # georeference maxima (sample=col, line=row;
        # reference: salience_predictions.py:109-110)
        plli, pllj = sl2latlon(pmj, pmi, mapinfo=cmfmap)
        clli, cllj = sl2latlon(cmj, cmi, mapinfo=cmfmap)

        detid = f"{cmflid}-{plab}"
        rows.append([detid, cmflid, imin, jmin, imax, jmax,
                     ppmx, ppmn, pmed, pmad, pmi, pmj, plli, pllj,
                     cpmx, cpmn, cmed, cmad, cmi, cmj, clli, cllj])

    return pd.DataFrame.from_records(rows, columns=OUTHDR)


def save_detections(outf, df, sheet="Plume_List"):
    """Write the canonical plume list as .xlsx AND .csv (reference:
    salience_predictions.py:152-192 — the xlsx is the trigger artifact
    for the whole msf_flow layer). The xlsx is written unconditionally
    via the stdlib writer (core.xlsx); no Excel engine is required."""
    from ..core.xlsx import write_xlsx

    dfcols = ["detid", "lid", "cmfmaxlat", "cmfmaxlon", "cmfmin", "cmfmax",
              "cmfmed", "cmfmad", "salmin", "salmax", "salmed", "salmad"]
    dfout = pd.DataFrame.from_records(df.loc[:, dfcols].values,
                                      columns=DETECTION_COLUMNS)
    dfout = dfout.set_index(DETECTION_COLUMNS[0])
    csvf = os.path.splitext(outf)[0] + ".csv"
    dfout.to_csv(csvf)
    rows = [[dfout.index.name] + list(dfout.columns)]
    for idx, row in dfout.iterrows():
        rows.append([idx] + list(row.values))
    write_xlsx(outf, rows, sheet_name=sheet)
    return csvf
