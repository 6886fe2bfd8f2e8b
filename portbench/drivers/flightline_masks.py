"""The flightline driver with the spectrometer masks on: one AVIRIS-NG
flightline after another through ``run_flightline(..., do_masks=True)``,
whose CMF and masks share one streamed read of the radiance (the fused
``cmf+masks`` stage).

Set-up writes the seeded scene as the flightline driver does, then paints
the configuration's features into the radiance file (flares, small flares,
glint, clouds and their shadows, each at its fixed place, each carrying the
scene's own noise), before the warm-up flightline. The traffic states the
masks' settings, which must be the ones ``run_flightline`` runs them with.

The check takes the flightline driver's post-processing readings, plus
three held to limits: ``cmf_gap_quiet``, the flightline driver's
``cmf_gap`` (every flightline) over the reference masks' clear pixels of
the columns that hold no painted feature, whose covariance is as well
conditioned as the flightline cell's, inf where the nodata masks differ or
a valid value anywhere is not finite; ``masks_gap``, the pixels of the
seeded flightline's 4-band mask that differ from the plain reference
(``reference/masks.py``), inf where another flightline of the window wrote
another mask file; and ``mask_features_missing``, the count of the painted
features the mask misses (a band that flags nothing, a flare core without
its grown ring, a grown region without a core, glint or a small flare that
grew). ``cmf_gap`` over every valid pixel and ``cmf_gap_clear`` over the
clear ones are printed, with their denominators, and held to no limit: the
features raise a feature column's correlation matrix's condition number
from ~2 to ~4e5, where float32 itself keeps two digits fewer and reads
within 2x of TF32.
"""

from __future__ import annotations

import inspect
import math
import os
import pathlib
import shutil
import sys

import numpy as np
import torch
from scipy import ndimage

from .. import checks
from ..envi import read_envi, read_header
from ..inputs import seeded_state_dict, write_scene
from ..reference import masks as ref_masks
from . import flightline

MASK_SETTINGS = ("cldbfr", "maskgrowradius", "mingrowarea", "block_step")


def wavelengths(cfg):
    """The band centres as the scene's header states them."""
    return np.array([float(f"{w:.2f}") for w in np.linspace(*cfg["wavelength_nm"],
                                                             cfg["bands"])])


def disc(lines, samples, line, sample, radius):
    """The (rows, cols) of the pixels within ``radius`` of (line, sample)."""
    r0, r1 = max(0, line - radius), min(lines, line + radius + 1)
    c0, c1 = max(0, sample - radius), min(samples, sample + radius + 1)
    rr, cc = np.mgrid[r0:r1, c0:c1]
    keep = (rr - line) ** 2 + (cc - sample) ** 2 <= radius * radius
    return rr[keep], cc[keep]


def features(cfg):
    """The configuration's features in painting order, shadows first and
    clouds over them: [(rows, cols, spectrum over the bands)]."""
    f = cfg["features"]
    nl, ns, nb = cfg["lines"], cfg["samples"], cfg["bands"]
    wl = wavelengths(cfg)
    lo, hi = f["saturation_nm"]
    swir = (wl.astype(np.float32) >= np.float32(lo)) & (wl.astype(np.float32) <= np.float32(hi))
    c = f["clouds"]
    knots_nm = list(c["knots_nm"])
    knots_nm[:3] = [wl[np.argmin(np.abs(wl - nm))] for nm in knots_nm[:3]]
    cloud = np.interp(wl, knots_nm, c["knots"])
    dr, dc = f["shadows"]["offset"]
    out = [disc(nl, ns, line + dr, sample + dc, radius) + (np.full(nb, f["shadows"]["radiance"]),)
           for line, sample, radius in c["discs"]]
    out += [disc(nl, ns, line, sample, radius) + (cloud,) for line, sample, radius in c["discs"]]
    for line, sample, n, m in f["glint"]["boxes"]:
        rr, cc = np.mgrid[line:line + n, sample:sample + m]
        out.append((rr.ravel(), cc.ravel(), np.full(nb, f["glint"]["radiance"])))
    for key in ("flares", "small_flares"):
        k = f[key]["size"]
        for line, sample in f[key]["cores"]:
            rr, cc = np.mgrid[line:line + k, sample:sample + k]
            out.append((rr.ravel(), cc.ravel(), np.where(swir, f[key]["radiance"], f["level"])))
    return out


def paint(rdn, cfg):
    """Paints the features into the BIL radiance file ``rdn``: each
    feature's spectrum times the pixel's own radiance over the scene's
    level, so that it carries the pixel's noise."""
    cube = np.memmap(rdn, dtype="<f4", mode="r+",
                     shape=(cfg["lines"], cfg["bands"], cfg["samples"]))
    for rows, cols, spectrum in features(cfg):
        x = cube[rows, :, cols]                                  # (pixels, bands)
        cube[rows, :, cols] = (spectrum[None, :] * x / cfg["features"]["level"]).astype(
            np.float32)
    cube.flush()
    del cube


def quiet_columns(cfg):
    """The columns that hold no painted pixel."""
    hit = np.zeros(cfg["samples"], bool)
    for _, cols, _ in features(cfg):
        hit[cols] = True
    return ~hit


def missing_features(mask, cfg):
    """The painted features that the 4-band ``mask`` misses (see the
    module), as a count."""
    f = cfg["features"]
    flare = mask[..., 2]
    missing = sum(not (mask[..., b] == 1).any() for b in range(4))
    _, n = ndimage.label(flare == 2, structure=np.ones((3, 3), bool))
    cores = f["flares"]["cores"]
    missing += n != len(cores)

    def around(line, sample, lines, samples):
        """The flare band on the box and its one-pixel ring."""
        return flare[max(0, line - 1):line + lines + 1, max(0, sample - 1):sample + samples + 1]

    k = f["flares"]["size"]
    missing += sum(not (around(line, sample, k, k) == 2).any() for line, sample in cores)
    k = f["small_flares"]["size"]
    for line, sample in f["small_flares"]["cores"]:
        missing += (around(line, sample, k, k) == 2).any()
        missing += not (flare[line:line + k, sample:sample + k] == 1).all()
    missing += sum((around(*box) == 2).any() for box in f["glint"]["boxes"])
    return int(missing)


class Driver(flightline.Driver):

    def setup(self):
        from srcfinder_torch.masks.cli import masks_for_flightline
        given = self.traffic["mask_settings"]
        runs = {k: p.default for k, p in inspect.signature(masks_for_flightline).parameters.items()
                if k in MASK_SETTINGS}
        if runs != given:
            raise ValueError(f"run_flightline makes the masks with {runs}; the traffic states "
                             f"{given}")
        wd = self.ctx.workdir
        self.rdn, self.lib, self.absorption = write_scene(wd, self.cfg, self.ctx.seed, self.dev)
        paint(self.rdn, self.cfg)
        self.sd = seeded_state_dict(self.ctx.seed, self.dev, self.cfg["weights"])
        self.weights = os.path.join(wd, "googlenet1ch_seeded.pt")
        torch.save({k: v.cpu() for k, v in self.sd.items()}, self.weights)
        shutil.rmtree(self._run(os.path.join(wd, "warmup"))["outdir"])

    def reference_masks(self):
        """The plain reference's mask of the scene, and the blocks whose
        flare growth had a seed."""
        c, s = self.cfg, self.traffic["mask_settings"]
        cube = np.memmap(self.rdn, dtype="<f4", mode="r",
                         shape=(c["lines"], c["bands"], c["samples"]))
        pixel_m = float(read_header(self.rdn + ".hdr")["map info"].strip("{}").split(",")[5])

        def read(r0, r1, idx):
            return np.ascontiguousarray(cube[r0:r1, idx, :].transpose(0, 2, 1))
        return ref_masks.flightline_masks(
            read, c["lines"], c["samples"], wavelengths(c),
            grow_px=ref_masks.radius_px(s["maskgrowradius"], pixel_m),
            cldbfr_px=ref_masks.radius_px(s["cldbfr"], pixel_m),
            mingrowarea=s["mingrowarea"], block_step=s["block_step"])

    def check(self):
        torch.cuda.empty_cache()
        nodata, limits = self.cfg["nodata"], self.ctx.limits
        ref, valid = self.reference_cmf()
        want, grown = self.reference_masks()
        over = {"cmf_gap": valid, "cmf_gap_clear": valid & (want == 0).all(axis=-1)}
        over["cmf_gap_quiet"] = over["cmf_gap_clear"] & quiet_columns(self.cfg)[None, :]
        gaps = []
        for prods in self.done:
            got = read_envi(prods["cmf"])[..., 3]
            same = np.array_equal(got == nodata, ~valid)
            g = {k: checks.max_rel_gap(got, ref, px) if same else math.inf
                 for k, px in over.items()}
            if not math.isfinite(g["cmf_gap"]):
                g["cmf_gap_quiet"] = math.inf
            gaps.append(g)
        j, shifts = self.sample(len(self.done))
        readings = {k: max(g[k] for g in gaps) for k in over}
        readings.update(self.check_one(self.done[j], shifts))
        mask = np.asarray(read_envi(self.done[j]["masks"]))
        raw = [pathlib.Path(p["masks"]).read_bytes() for p in self.done]
        alike = [r == raw[j] for r in raw]
        readings["masks_gap"] = (float(np.any(mask != want, axis=-1).sum())
                                 if all(alike) and mask.shape == want.shape else math.inf)
        readings["mask_features_missing"] = missing_features(mask, self.cfg)
        print(f"masks: flare growth in blocks {grown}; "
              + ", ".join(f"{k} {readings[k]!r} (limit {limits.get(k)}; over max |ref| "
                          f"{float(np.abs(ref[px]).max())!r} on {int(px.sum())} pixels)"
                          for k, px in over.items()), file=sys.stderr)
        rows = checks.verdict(readings, limits)
        held = [k for k in over if k in limits]
        bad = {i for i, (g, a) in enumerate(zip(gaps, alike))
               if not a or any(g[k] > limits[k] for k in held)}
        if not checks.passed([r for r in rows if r["name"] not in over]):
            bad.add(j)
        return rows, len(bad)
