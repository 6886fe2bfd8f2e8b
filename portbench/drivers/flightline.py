"""One AVIRIS-NG flightline after another through the port's
``run_flightline`` (radiance -> CMF -> FCN saliency -> plume list -> IME).

Set-up writes the seeded scene and library into the run's work directory
(reads then come from the page cache) and the seeded weights as a ``.pt``
checkpoint, and runs one flightline to warm every shape. Each unit of the
window is one flightline into a fresh output directory. After the window
every flightline's ppm*m band is held to the plain matched filter in
float64, and one flightline drawn from the seed has its saliency held to the
literal shift-and-stitch FCN on its own ppm*m band (a seeded sample of the
1024 shifts), and its plume list and IME table to the plain ones worked out
from its own products.
"""

from __future__ import annotations

import math
import os
import shutil

import numpy as np
import pandas as pd
import torch

from .. import checks
from ..envi import read_envi
from ..inputs import seeded_state_dict, write_scene
from ..reference import cmf as ref_cmf
from ..reference import post as ref_post
from ..reference.googlenet import GoogLeNet1ch, identity

SCALE = 32


def geo_of(cfg):
    m = cfg["map_info"]
    return dict(ulx=float(m[3]), uly=float(m[4]), ps=float(m[5]), zone=int(m[7]),
                north=m[8].upper().startswith("N"))


def shift_pixels(lines, samples, t, l):
    """Rows and columns of the scene that shift (top t, left l) of the
    stitch fills, and their positions in that shift's output map."""
    rows = np.arange(lines)
    cols = np.arange(samples)
    r = rows[(rows + SCALE // 2) % SCALE == SCALE - 1 - t]
    c = cols[(cols + SCALE // 2) % SCALE == SCALE - 1 - l]
    return r, c, (r + SCALE // 2) // SCALE, (c + SCALE // 2) // SCALE


def shift_saliency(model, band, mean, std, shifts, device, rounding=identity, nodata=-9999.0):
    """The literal per-shift FCN (reference fcn_pred_pipeline.py): the
    clamped, normalised band on a zero canvas, one forward of the view of
    each shift (top, left). Returns [(rows, cols, probabilities)]."""
    x = (np.clip(band, 0.0, 4000.0) - mean) / std
    h, w = band.shape
    ph, pw = SCALE - h % SCALE, SCALE - w % SCALE
    canvas = np.zeros((h + ph + 2 * SCALE, w + pw + 2 * SCALE), np.float32)
    canvas[SCALE:SCALE + h, SCALE:SCALE + w] = x
    hp, wp = canvas.shape[0] - SCALE, canvas.shape[1] - SCALE
    canvas = torch.from_numpy(canvas).to(device)
    out = []
    with torch.no_grad():
        for t, l in shifts:
            view = canvas[SCALE - t:SCALE - t + hp, SCALE - l:SCALE - l + wp]
            prob = model.fcn_probability(view[None, None], rounding)[0].cpu().numpy()
            r, c, a, b = shift_pixels(h, w, t, l)
            out.append((r, c, prob[np.ix_(a, b)]))
    return out


class StageSpans:
    """``run_flightline``'s progress callback: each "[STAGE] name" line
    opens a profiler span "run_flightline stage name", its "done" line
    closes it, so the trace names the host work of each stage."""

    def __init__(self):
        self.span = None

    def __call__(self, msg):
        from torch.autograd.profiler import record_function
        if not msg.startswith("[STAGE] "):
            return
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
        if " done in " not in msg:
            self.span = record_function("run_flightline stage " + msg[len("[STAGE] "):])
            self.span.__enter__()


def reference_model(sd, device):
    model = GoogLeNet1ch()
    model.load_state_dict({k: v.to("cpu") for k, v in sd.items()})
    return model.to(device).eval()


class Driver:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.dev = ctx.devices[0]
        self.done, self.timers = [], []

    def setup(self):
        wd = self.ctx.workdir
        self.rdn, self.lib, self.absorption = write_scene(wd, self.cfg, self.ctx.seed, self.dev)
        self.sd = seeded_state_dict(self.ctx.seed, self.dev, self.cfg["weights"])
        self.weights = os.path.join(wd, "googlenet1ch_seeded.pt")
        torch.save({k: v.cpu() for k, v in self.sd.items()}, self.weights)
        shutil.rmtree(self._run(os.path.join(wd, "warmup"))["outdir"])

    def _run(self, outdir):
        from srcfinder_torch.flow.pipeline_cli import run_flightline
        t = self.traffic
        prods = run_flightline(
            self.rdn, self.lib, self.weights, outdir, model_name=self.cfg["model_name"],
            prob_thr=t["prob_thr"], ppmm_thr=t["ppmm_thr"], method=t["fcn_method"],
            do_ime=t["ime"], do_masks=t["masks"], dtype=t["cmf_dtype"],
            fcn_dtype=t["fcn_dtype"], col_chunk=t["col_chunk"], progress=StageSpans(),
            device=self.dev)
        prods["outdir"] = outdir
        return prods

    def unit(self):
        prods = self._run(os.path.join(self.ctx.workdir, f"out{len(self.done)}"))
        self.done.append(prods)
        self.timers.append(dict(prods["timers"]))

    def end_to_end(self, window_s):
        return {"flightline_s": window_s / len(self.done)}

    def layer_context(self):
        return dict(timers=self.timers)

    # ---- the check ------------------------------------------------------
    def reference_cmf(self, dtype=torch.float64, rounding=None):
        c = self.cfg
        a0, a1 = c["active_bands"]
        cube = np.memmap(self.rdn, dtype="<f4", mode="r",
                         shape=(c["lines"], c["bands"], c["samples"]))
        x = torch.from_numpy(np.ascontiguousarray(cube[:, a0 - 1:a1, :])).to(self.dev)
        absorption = self.absorption[a0 - 1:a1]
        ppmm, valid = ref_cmf.matched_filter(x.permute(0, 2, 1), absorption, dtype=dtype,
                                             rounding=rounding)
        return ppmm.cpu().numpy(), valid.cpu().numpy()

    def sample(self, n):
        rng = np.random.default_rng(self.ctx.seed)
        idx = rng.choice(SCALE * SCALE, size=self.traffic["check_shifts"], replace=False)
        return int(rng.integers(n)), [divmod(int(i), SCALE) for i in idx]

    def check(self):
        torch.cuda.empty_cache()
        cfg, t, nodata = self.cfg, self.traffic, self.cfg["nodata"]
        ref, valid = self.reference_cmf()
        gaps = []
        for prods in self.done:
            got = read_envi(prods["cmf"])[..., 3]
            same_mask = np.array_equal(got == nodata, ~valid)
            gaps.append(checks.max_rel_gap(got, ref, valid) if same_mask else math.inf)
        j, shifts = self.sample(len(self.done))
        readings = {"cmf_gap": max(gaps)}
        readings.update(self.check_one(self.done[j], shifts))
        rows = checks.verdict(readings, self.ctx.limits)
        bad = {i for i, g in enumerate(gaps) if g > self.ctx.limits["cmf_gap"]}
        if not checks.passed([r for r in rows if r["name"] != "cmf_gap"]):
            bad.add(j)
        return rows, len(bad)

    def check_one(self, prods, shifts):
        cfg, t, nodata = self.cfg, self.traffic, self.cfg["nodata"]
        product = np.asarray(read_envi(prods["cmf"]))
        band = product[..., 3].astype(np.float32)
        sal = np.asarray(read_envi(prods["saliency"])[..., 0])
        mean, std = cfg["norm"]
        model = reference_model(self.sd, self.dev)
        gap = 0.0 if np.array_equal(sal == nodata, band == nodata) else math.inf
        for r, c, want in shift_saliency(model, band, mean, std, shifts, self.dev):
            got = sal[np.ix_(r, c)]
            keep = band[np.ix_(r, c)] != nodata
            if keep.any():
                gap = max(gap, float(np.abs(got[keep] - want[keep]).max()))
        del model
        geo, lid = geo_of(cfg), os.path.basename(self.rdn).split("_")[0]
        want = ref_post.candidates(sal, product[..., 3], product[..., 0], t["prob_thr"],
                                   t["ppmm_thr"], lid, geo)
        csvf = prods.get("detections_csv")
        got = pd.read_csv(csvf).values.tolist() if csvf and os.path.exists(csvf) else []
        out = {"saliency_gap": gap, "plumes_gap": checks.table_gap(got, want)}
        if t["ime"]:
            want = ref_post.ime_table(band, geo)
            ime = pd.read_csv(prods["ime_csv"])
            out["ime_gap"] = checks.table_gap(ime.values.tolist(), want)
        return out

    def release(self):
        for prods in self.done:
            shutil.rmtree(prods["outdir"], ignore_errors=True)
