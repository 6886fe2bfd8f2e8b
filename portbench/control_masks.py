"""The control of the masks cell's checks (``control.py``'s flightline
control on the painted scene of ``drivers/flightline_masks.py``): the plain
matched filter and shift-and-stitch FCN one precision step below the
configuration's (float32 -> TF32), read by the cell's limits on
``cmf_gap_quiet`` (over the clear pixels of the columns that hold no
painted feature) and ``saliency_gap``, and by the readings held to no
limit, ``cmf_gap`` and ``cmf_gap_clear`` (over the pixels the reference
masks leave clear). Not part of a run; run on the card:

    python3 portbench/control_masks.py --workload flightline-2801-masks-shift --seeds 11,12,13

prints one JSON line per seed: {"seed", "readings", "correct": the cell's
verdict on the CMF and saliency readings (false where the control fails a
limit, as it has to)}. ``--plain-f32`` adds the readings of the plain
matched filter in float32 without TF32's rounding (``cmf_gap_f32``,
``cmf_gap_clear_f32``, ``cmf_gap_quiet_f32``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import checks, harness  # noqa: E402
from portbench.control import LOWER  # noqa: E402


def masks_readings(ctx, device, plain_f32=False):
    from portbench.drivers import flightline as fl
    from portbench.drivers import flightline_masks as fm
    from portbench.inputs import seeded_state_dict, write_scene
    d = fm.Driver(ctx)
    d.rdn, _, d.absorption = write_scene(ctx.workdir, ctx.cfg, ctx.seed, device)
    fm.paint(d.rdn, ctx.cfg)
    d.sd = seeded_state_dict(ctx.seed, device, ctx.cfg["weights"])
    ref, valid = d.reference_cmf()
    want, _ = d.reference_masks()
    over = {"cmf_gap": valid, "cmf_gap_clear": valid & (want == 0).all(axis=-1)}
    over["cmf_gap_quiet"] = over["cmf_gap_clear"] & fm.quiet_columns(ctx.cfg)[None, :]
    low, _ = d.reference_cmf(torch.float32, LOWER[ctx.traffic["cmf_dtype"]])
    out = {k: checks.max_rel_gap(low, ref, px) for k, px in over.items()}
    if plain_f32:
        f32, _ = d.reference_cmf(torch.float32)
        out.update({k + "_f32": checks.max_rel_gap(f32, ref, px) for k, px in over.items()})
    _, shifts = d.sample(1)
    model = fl.reference_model(d.sd, device)
    mean, std = ctx.cfg["norm"]
    nodata = ctx.cfg["nodata"]
    band, low_band = ref.astype(np.float32), low.astype(np.float32)
    band[~valid] = low_band[~valid] = nodata
    gap = 0.0
    for (r, c, want_p), (_, _, got) in zip(
            fl.shift_saliency(model, band, mean, std, shifts, device),
            fl.shift_saliency(model, low_band, mean, std, shifts, device,
                              LOWER[ctx.traffic["fcn_dtype"]])):
        keep = band[np.ix_(r, c)] != nodata
        if keep.any():
            gap = max(gap, float(np.abs(got[keep] - want_p[keep]).max()))
    out["saliency_gap"] = gap
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--plain-f32", action="store_true")
    args = p.parse_args(argv)
    wl = harness.load_json(os.path.join(harness.HERE, "workloads", args.workload + ".json"))
    cfg = harness.load_json(os.path.join(harness.HERE, "configs", wl["config"] + ".json"))
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic", wl["traffic"] + ".json"))
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="portbench-control-") as wd:
            ctx = harness.Context(args.workload, seed, cfg, traffic, wl["limits"], 1,
                                  [device], wd)
            readings = masks_readings(ctx, device, args.plain_f32)
        limits = {k: v for k, v in wl["limits"].items() if k in readings}
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "correct": checks.passed(checks.verdict(readings, limits))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
