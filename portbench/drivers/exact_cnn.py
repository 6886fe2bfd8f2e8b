"""``cnn-pred``'s exact dense CNN: one 256 x 256 window per pixel, through the
port's ``cnn_saliency_image`` on one card, or on a mesh of cards through the
steps of that call around ``cnn_window_saliency_sharded``.

Set-up makes the seeded ppm*m band and weights, builds the port's model and
folds it once (``fold_inference``, as the CLI's call would), and runs one
block to warm every shape. Each unit of the window is one call on the next
block of ``block_lines`` lines of the band, wrapping at its end. After the
window every call's nodata stamp is checked, and a sample of windows drawn
from the seed in every call is held to the plain GoogLeNet-1ch in float32
(root mean square of the gaps; in a bfloat16 cell, over that of the plain
network with its operands rounded to bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import checks
from ..inputs import seeded_band, seeded_state_dict
from ..reference.googlenet import GoogLeNet1ch, bf16_round, identity

# the plain reference's operands at a cell's own precision, for ``saliency_rms_ratio``
AT_DTYPE = {"bfloat16": bf16_round}


def rms(gaps):
    return math.sqrt(float(np.mean(np.square(gaps))))


def readings(gaps, own=None):
    """``saliency_rms_gap``: the root mean square of the gaps (saliency -
    plain float32 reference); with ``own``, the gaps of the plain reference
    with its operands rounded to the cell's precision on the same windows,
    ``saliency_rms_ratio``: the first over the second, the gap measured in
    units of the gap that the stated precision's operands give on this
    seed's weights and band."""
    out = {"saliency_rms_gap": rms(np.concatenate(gaps))}
    if own is not None:
        out["saliency_rms_ratio"] = out["saliency_rms_gap"] / max(
            rms(np.concatenate(own)), 1e-300)
    return out


def block_rows(k, block, lines):
    return (k * block + np.arange(block)) % lines


def reference_windows(model, block, picks, mean, std, dim, device, rounding=identity,
                      chunk=256):
    """Class-1 probability of the windows of ``block`` (a 2-D ppm*m array)
    centred on the pixels ``picks`` (flat indices), each cut from the
    clamped, normalised block zero-padded dim/2 before and dim/2 - 1 after
    (reference cnn_pred_pipeline.py)."""
    h, w = block.shape
    x = (np.clip(block, 0.0, 4000.0) - mean) / std
    padded = np.zeros((h + dim - 1, w + dim - 1), np.float32)
    padded[dim // 2:dim // 2 + h, dim // 2:dim // 2 + w] = x
    padded = torch.from_numpy(padded).to(device)
    out = []
    with torch.no_grad():
        for i in range(0, len(picks), chunk):
            p = picks[i:i + chunk]
            wins = torch.stack([padded[r:r + dim, c:c + dim] for r, c in
                                (divmod(int(q), w) for q in p)])
            out.append(model.probability(wins[:, None], rounding).cpu().numpy())
    return np.concatenate(out)


class Driver:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.devices = ctx.devices
        self.dtype = getattr(torch, self.traffic["dtype"])
        self.outputs = []

    def setup(self):
        from srcfinder_torch.models.googlenet import GoogLeNet, fold_inference
        dev = self.devices[0]
        self.band = seeded_band(self.cfg, self.ctx.seed, dev)
        self.sd = seeded_state_dict(self.ctx.seed, dev, self.cfg["weights"])
        model = GoogLeNet(num_classes=2)
        model.load_state_dict(self.sd)
        self.model = fold_inference(model.eval()).to(device=dev, dtype=self.dtype)
        self.call(0)

    def call(self, k):
        from srcfinder_torch.detect.cnn_pipeline import (cnn_saliency_image,
                                                         cnn_window_saliency_sharded)
        from srcfinder_torch.detect.preprocess import norm_for_model, preprocess_ch4
        c, t = self.cfg, self.traffic
        blk = self.band[block_rows(k, t["block_lines"], c["lines"])]
        dev = self.devices[0]
        if len(self.devices) == 1:
            sal = cnn_saliency_image(blk, self.model, model_name=c["model_name"], dim=c["dim"],
                                     batch=t["batch"], dtype=self.dtype, trunk=t["trunk"],
                                     device=dev)
        else:
            mean, std = norm_for_model(c["model_name"])
            raw = torch.as_tensor(blk, device=dev)
            x = preprocess_ch4(raw.to(self.dtype), mean, std)
            s = cnn_window_saliency_sharded(self.model, x, self.devices, dim=c["dim"],
                                            batch=t["batch"], trunk=t["trunk"])
            sal = torch.where(raw == c["nodata"], torch.full_like(raw, c["nodata"]), s.float())
        return blk, sal.cpu().numpy()

    def unit(self):
        from torch.autograd.profiler import record_function
        with record_function("exact CNN call"):
            self.outputs.append(self.call(len(self.outputs)))

    def windows_per_call(self):
        return self.traffic["block_lines"] * self.cfg["samples"]

    def end_to_end(self, window_s):
        return {"cnn_windows_per_s": len(self.outputs) * self.windows_per_call() / window_s}

    def layer_context(self):
        per = self.windows_per_call()
        return dict(windows=len(self.outputs) * per,
                    batches=len(self.outputs) * math.ceil(per / self.traffic["batch"]))

    def picks(self, k):
        n = self.windows_per_call()
        rng = np.random.default_rng([self.ctx.seed, k])
        return np.sort(rng.choice(n, size=self.traffic["check_windows_per_call"], replace=False))

    def check(self):
        """The numbers of the cell's limits (:func:`readings`) over the
        sampled windows of every call; a call whose nodata stamp, range or
        finiteness is wrong reads inf. (One window's largest gap swings from
        seed to seed by its nature; the root mean square of the gaps follows
        each seed's weights, so a bfloat16 cell holds it against the gap of
        the plain reference with its operands rounded to bfloat16.)"""
        torch.cuda.empty_cache()
        c, nodata = self.cfg, self.cfg["nodata"]
        model = GoogLeNet1ch()
        model.load_state_dict({k: v.cpu() for k, v in self.sd.items()})
        model = model.to(self.devices[0]).eval()
        mean, std = c["norm"]
        limits = self.ctx.limits
        at = AT_DTYPE[self.traffic["dtype"]] if "saliency_rms_ratio" in limits else None
        gaps, own = [], []
        for k, (blk, sal) in enumerate(self.outputs):
            nod = blk == nodata
            ok = (sal[nod] == nodata).all() and np.isfinite(sal[~nod]).all() and \
                ((sal[~nod] >= 0) & (sal[~nod] <= 1)).all()
            p = self.picks(k)
            p = p[~nod.ravel()[p]]
            want = reference_windows(model, blk, p, mean, std, c["dim"], self.devices[0])
            gaps.append(sal.ravel()[p].astype(np.float64) - want if ok else np.full(1, np.inf))
            if at is not None:
                own.append(reference_windows(model, blk, p, mean, std, c["dim"],
                                             self.devices[0], at).astype(np.float64) - want)
        own = own if at is not None else None
        rows = checks.verdict(readings(gaps, own), limits)
        failed = sum(not checks.passed(checks.verdict(
            readings([g], None if own is None else [own[k]]), limits))
            for k, g in enumerate(gaps))
        return rows, failed

    def release(self):
        self.outputs = []
