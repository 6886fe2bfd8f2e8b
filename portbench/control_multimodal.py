"""The control of the multimodal CMF cell's checks: the plain multimodal
reference (``reference/cmf_multimodal.py``) put in the program's place on
the painted scene of ``drivers/cmf_multimodal.py`` and computed one
precision step below the configuration's (float32 -> TF32), read by the
cell's ``cmf_gap`` and ``labels_gap`` against the float64 reference. Not
part of a run; run on the card:

    python3 portbench/control_multimodal.py --workload cmf-2801-multimodal-k4 --seeds 11,12,13

prints one JSON line per seed: {"seed", "readings", "correct": the cell's
verdict on them (false where the control fails a limit, as it has to)}.
``--plain-f32`` adds ``cmf_gap_f32``, the reference in float32 without
TF32's rounding.
"""

from __future__ import annotations

import argparse
import json
import math
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


def multimodal_readings(ctx, device, plain_f32=False):
    from portbench.drivers import cmf_multimodal as cm
    from portbench.inputs import write_scene
    d = cm.Driver(ctx)
    d.rdn, _, d.absorption = write_scene(ctx.workdir, ctx.cfg, ctx.seed, device)
    cm.paint(d.rdn, ctx.cfg)
    ref, given, modes, valid = d.reference()

    def gaps(low):
        ppmm, low_given, low_modes, _ = low
        same = np.array_equal(low_given, given)
        return (checks.max_rel_gap(ppmm, ref, given) if same else math.inf,
                cm.labels_gap(low_modes, modes, valid, ctx.traffic["bgmodes"]))

    out = dict(zip(("cmf_gap", "labels_gap"),
                   gaps(d.reference(torch.float32, LOWER[ctx.traffic["cmf_dtype"]]))))
    if plain_f32:
        out["cmf_gap_f32"], out["labels_gap_f32"] = gaps(d.reference(torch.float32))
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
            readings = multimodal_readings(ctx, device, args.plain_f32)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "correct": checks.passed(checks.verdict(readings, wl["limits"]))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
