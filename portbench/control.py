"""The controls of the cells' checks: the plain reference put in the
program's place and computed one precision step below the configuration's
(float32 -> TF32, bfloat16 -> float8 e4m3), read by the same numbers as a
run. Not part of a run; run on the card for the readings that set the
limits' upper ends:

    python3 portbench/control.py --workload CELL --seeds 11,12,13 [--calls N]

prints one JSON line per seed: {"seed", "readings": {number: value},
"correct": the cell's own verdict on those readings (false where the
control fails a limit, as it has to)}.
``calls``: how many of an exact-CNN cell's calls to sample (a run's window
holds about that many).
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
from portbench.reference.googlenet import GoogLeNet1ch, fp8_round, tf32_round  # noqa: E402

LOWER = {"float32": tf32_round, "bfloat16": fp8_round}


def flightline_readings(ctx, device):
    from portbench.drivers import flightline as fl
    from portbench.inputs import seeded_state_dict, write_scene
    d = fl.Driver(ctx)
    d.rdn, _, d.absorption = write_scene(ctx.workdir, ctx.cfg, ctx.seed, device)
    d.sd = seeded_state_dict(ctx.seed, device, ctx.cfg["weights"])
    rounding = LOWER[ctx.traffic["cmf_dtype"]]
    ref, valid = d.reference_cmf()
    low, _ = d.reference_cmf(torch.float32, rounding)
    out = {"cmf_gap": checks.max_rel_gap(low, ref, valid)}
    _, shifts = d.sample(1)
    model = fl.reference_model(d.sd, device)
    mean, std = ctx.cfg["norm"]
    nodata = ctx.cfg["nodata"]
    band, low_band = ref.astype(np.float32), low.astype(np.float32)
    band[~valid] = low_band[~valid] = nodata
    gap = 0.0
    for (r, c, want), (_, _, got) in zip(
            fl.shift_saliency(model, band, mean, std, shifts, device),
            fl.shift_saliency(model, low_band, mean, std, shifts, device,
                              LOWER[ctx.traffic["fcn_dtype"]])):
        keep = band[np.ix_(r, c)] != nodata
        if keep.any():
            gap = max(gap, float(np.abs(got[keep] - want[keep]).max()))
    out["saliency_gap"] = gap
    return out


def exact_cnn_readings(ctx, device, calls):
    from portbench.drivers import exact_cnn as ec
    from portbench.inputs import seeded_band, seeded_state_dict
    d = ec.Driver(ctx)
    band = seeded_band(ctx.cfg, ctx.seed, device)
    sd = seeded_state_dict(ctx.seed, device, ctx.cfg["weights"])
    model = GoogLeNet1ch()
    model.load_state_dict({k: v.cpu() for k, v in sd.items()})
    model = model.to(device).eval()
    c, t = ctx.cfg, ctx.traffic
    mean, std = c["norm"]
    at = ec.AT_DTYPE[t["dtype"]] if "saliency_rms_ratio" in ctx.limits else None
    gaps, own = [], []
    for k in range(calls):
        blk = band[ec.block_rows(k, t["block_lines"], c["lines"])]
        p = d.picks(k)
        p = p[blk.ravel()[p] != c["nodata"]]
        want = ec.reference_windows(model, blk, p, mean, std, c["dim"], device)
        got = ec.reference_windows(model, blk, p, mean, std, c["dim"], device,
                                   LOWER[t["dtype"]])
        gaps.append(got.astype(np.float64) - want)
        if at is not None:
            own.append(ec.reference_windows(model, blk, p, mean, std, c["dim"], device,
                                            at).astype(np.float64) - want)
    return ec.readings(gaps, own if at is not None else None)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=6)
    p.add_argument("--device", default="cuda")
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
            if traffic["driver"] == "flightline":
                readings = flightline_readings(ctx, device)
            else:
                readings = exact_cnn_readings(ctx, device, args.calls)
        rows = checks.verdict(readings, wl["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "correct": checks.passed(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
