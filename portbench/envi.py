"""Reads the program's ENVI products for the checks: the header's few keys
that place the data, then a read-only map of the file."""

from __future__ import annotations

import os
import re

import numpy as np

_TYPES = {1: "u1", 2: "i2", 3: "i4", 4: "f4", 5: "f8", 12: "u2"}


def read_header(path: str) -> dict:
    text = open(path).read()
    out = {}
    for key, val in re.findall(r"^\s*([^=\n]+?)\s*=\s*(\{[^}]*\}|[^\n]*)", text, re.M):
        out[key.strip().lower()] = val.strip()
    return out


def read_envi(base: str) -> np.ndarray:
    """The image ``base`` (header ``base.hdr``) as (lines, samples, bands)."""
    h = read_header(base + ".hdr")
    lines, samples, bands = (int(h[k]) for k in ("lines", "samples", "bands"))
    order = "<" if int(h.get("byte order", 0)) == 0 else ">"
    dtype = np.dtype(order + _TYPES[int(h["data type"])])
    il = h.get("interleave", "bsq").lower()
    shape = {"bip": (lines, samples, bands), "bil": (lines, bands, samples),
             "bsq": (bands, lines, samples)}[il]
    mm = np.memmap(base if os.path.exists(base) else base + ".img", dtype=dtype, mode="r",
                   offset=int(h.get("header offset", 0)), shape=shape)
    axes = {"bip": (0, 1, 2), "bil": (0, 2, 1), "bsq": (1, 2, 0)}[il]
    return np.transpose(mm, axes)
