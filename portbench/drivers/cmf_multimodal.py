"""The multimodal CMF product alone, as ``srcfinder-cmf -k K -r -m`` makes
it: one AVIRIS-NG flightline after another through the port's
``robust_mf_image`` with ``bgmodes``, ``pcadim``, ``reject``, ``regfull``
and ``save_bgmeta`` from the traffic (PCA, k-means and one shrinkage fit
per background mode in each column chunk).

Set-up writes the seeded scene as the flightline driver does, then paints
the configuration's surface classes into the radiance file (each field a
rectangle of one class, each class a factor over the bands times the
pixel's own radiance, so that it keeps the scene's noise; only the noise
comes from the seed), then makes one product to warm every shape. Each
unit of the window is one product into a fresh output name.

The check, after the window, holds two numbers to limits: ``cmf_gap``,
every product's ppm*m band against the plain multimodal reference's
(``reference/cmf_multimodal.py``, float64, k-means from the planted
classes) as ``checks.max_rel_gap``, inf where the nodata masks differ (so
that a mode rejected in other columns shows); and ``labels_gap``, on one
product drawn from the seed, the share of the valid pixels whose cluster
id in the ``_bgmeta`` image names another mode than the reference's, the
modes of each column matched by their largest overlap first.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from .. import checks, product_spans
from ..envi import read_envi
from ..inputs import write_scene
from ..reference import cmf_multimodal as ref_mm

DTYPES = {"float32": np.float32, "float64": np.float64}


def class_map(cfg):
    """(lines, samples) int8 class of every pixel, from the fields; -1
    where no field lies."""
    out = np.full((cfg["lines"], cfg["samples"]), -1, np.int8)
    for l0, l1, s0, s1, k in cfg["surfaces"]["fields"]:
        out[l0:l1, s0:s1] = k
    return out


def class_factors(cfg):
    """(classes, bands) float32 factor of each class over the band centres:
    level + tilt x (wl - first) / (last - first)."""
    lo, hi = cfg["wavelength_nm"]
    t = (np.linspace(lo, hi, cfg["bands"]) - lo) / (hi - lo)
    return np.stack([c["level"] + c["tilt"] * t for c in cfg["surfaces"]["classes"]]
                    ).astype(np.float32)


def paint(rdn, cfg):
    """Multiplies each field of the BIL radiance file ``rdn`` by its class's
    factors, then stamps the nodata pixels again."""
    cube = np.memmap(rdn, dtype="<f4", mode="r+",
                     shape=(cfg["lines"], cfg["bands"], cfg["samples"]))
    factors = class_factors(cfg)
    for l0, l1, s0, s1, k in cfg["surfaces"]["fields"]:
        cube[l0:l1, :, s0:s1] *= factors[k][None, :, None]
    for r, c in cfg["nodata_pixels"]:
        cube[r, :, c] = cfg["nodata"]
    cube.flush()
    del cube


def labels_gap(got, want, valid, k):
    """Share of the ``valid`` pixels whose label in ``got`` (L, C) names
    another mode than ``want``'s, once each column's labels are matched to
    ``want``'s modes greedily by their largest overlap first; a label
    outside 0..k-1 matches nothing."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    total = int(valid.sum())
    if got.shape != want.shape or total == 0:
        return math.inf
    C = got.shape[1]
    keep = valid & (got >= 0) & (got < k) & (want >= 0) & (want < k)
    cols = np.broadcast_to(np.arange(C), got.shape)[keep]
    overlap = np.bincount((cols * k + got[keep]) * k + want[keep],
                          minlength=C * k * k).reshape(C, k, k).astype(np.int64)
    matched = np.zeros(C, np.int64)
    free = overlap.copy()
    for _ in range(k):
        flat = free.reshape(C, -1).argmax(axis=1)
        g, w = np.divmod(flat, k)
        matched += free[np.arange(C), g, w].clip(min=0)
        free[np.arange(C), g, :] = -1
        free[np.arange(C), :, w] = -1
    return float(total - matched.sum()) / total


class Driver:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.dev = ctx.devices[0]
        self.done = []

    def setup(self):
        wd = self.ctx.workdir
        self.rdn, self.lib, self.absorption = write_scene(wd, self.cfg, self.ctx.seed, self.dev)
        paint(self.rdn, self.cfg)
        self._run(os.path.join(wd, "warmup"))

    def _run(self, outfile):
        from srcfinder_torch.cmf.pipeline import robust_mf_image
        t = self.traffic
        res = robust_mf_image(
            self.rdn, self.lib, outfile, bgmodes=t["bgmodes"], pcadim=t["pcadim"],
            reject=t["reject"], regfull=t["regfull"], save_bgmeta=t["save_bgmeta"],
            col_chunk=t["col_chunk"], dtype=DTYPES[t["cmf_dtype"]],
            cond_thresh=t["cond_thresh"], device=self.dev)
        return dict(outfile=outfile, f64_columns=res["f64_columns"])

    def unit(self):
        self.done.append(self._run(os.path.join(self.ctx.workdir, f"cmf{len(self.done)}")))

    def end_to_end(self, window_s):
        return {"flightline_s": window_s / len(self.done)}

    def layer_context(self):
        return {}

    # ---- the check ------------------------------------------------------
    def reference(self, dtype=torch.float64, rounding=None):
        """The plain multimodal reference on the painted scene: (ppm*m,
        estimate given, mode, input valid), each (lines, samples) numpy."""
        c, t = self.cfg, self.traffic
        a0, a1 = c["active_bands"]
        cube = np.memmap(self.rdn, dtype="<f4", mode="r",
                         shape=(c["lines"], c["bands"], c["samples"]))
        x = torch.from_numpy(np.ascontiguousarray(cube[:, a0 - 1:a1, :])).to(self.dev)
        x = x.permute(0, 2, 1)
        ppmm, given, modes = ref_mm.matched_filter_multimodal(
            x, self.absorption[a0 - 1:a1], class_map(c), t["bgmodes"], pcadim=t["pcadim"],
            reject=t["reject"], dtype=dtype, rounding=rounding)
        return ppmm.cpu().numpy(), given.cpu().numpy(), modes.cpu().numpy(), \
            (modes >= 0).cpu().numpy()

    def check(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        nodata, limits, k = self.cfg["nodata"], self.ctx.limits, self.traffic["bgmodes"]
        ref, given, modes, valid = self.reference()
        gaps = []
        for prods in self.done:
            got = read_envi(prods["outfile"])[..., 3]
            same = np.array_equal(got == nodata, ~given)
            gaps.append(checks.max_rel_gap(got, ref, given) if same else math.inf)
        j = int(np.random.default_rng(self.ctx.seed).integers(len(self.done)))
        ids = read_envi(self.done[j]["outfile"] + "_bgmeta")[..., 0]
        readings = {"cmf_gap": max(gaps), "labels_gap": labels_gap(ids, modes, valid, k)}
        lost = [int(((modes == m) & ~given).any(axis=0).sum()) for m in range(k)]
        rejected = product_spans.rejected_per_mode(product_spans.last_product())
        print(f"cmf_multimodal: {len(self.done)} products, cmf_gap {readings['cmf_gap']!r} "
              f"(limit {limits.get('cmf_gap')}; over max |ref| {float(np.abs(ref[given]).max())!r}"
              f" on {int(given.sum())} pixels), labels_gap {readings['labels_gap']!r} on "
              f"product {j}; reference rejects modes {lost} on that many columns "
              f"({int((valid & ~given).sum())} valid pixels without an estimate), the program's "
              f"cmf.mode spans {rejected}; f64 columns "
              f"{[p['f64_columns'] for p in self.done]}", file=sys.stderr)
        rows = checks.verdict(readings, limits)
        bad = {i for i, g in enumerate(gaps) if g > limits["cmf_gap"]}
        if readings["labels_gap"] > limits["labels_gap"]:
            bad.add(j)
        return rows, len(bad)

    def release(self):
        """The products lie in the run's work directory, which the harness
        removes."""
