"""CLI: FCN shift-and-stitch saliency map
(reference: cnn/fcn_pred_pipeline.py:98-147).

usage: python -m srcfinder_torch.detect.fcn_cli FLIGHTLINE [FLIGHTLINE ...]
           -m multi_64 -w W.npz [--method auto|shift|phase|phase-blocked|dilated]
           [--scene-batch 2] [--dtype float32|bfloat16] [--device cuda|cpu] -o OUT

With several flightlines, scenes go ``--scene-batch`` at a time through
one phase pass (``fcn_phase_saliency_batch``): each scene is zero-padded
to the group's largest (H, W) and cropped after. A group whose pixels
exceed ``MAX_UNBLOCKED_PX`` (environment override SRCFINDER_FCN_MAX_PX)
runs scene by scene instead, through the halo-blocked path when one scene
alone exceeds it.
"""

from __future__ import annotations

import os
import sys
import time

from .cnn_cli import _run, build_parser as _cnn_parser


def build_parser():
    p = _cnn_parser()
    p.description = "Generate flightline saliency maps with a FCN (PyTorch/CUDA)."
    p.add_argument("--scale", "-s", type=int, default=32,
                   help="Downscaling factor of the model")
    p.add_argument("--scene-batch", type=int, default=2,
                   help="flightlines per device batch with several flightlines")
    for action in p._actions:
        if action.dest == "method":
            action.choices = ["auto", "shift", "phase", "phase-blocked", "dilated"]
            action.default = "auto"
            action.help = ("auto (phase when scale == 32; line-blocked past "
                           "SRCFINDER_FCN_MAX_LINES lines or SRCFINDER_FCN_MAX_PX "
                           "pixels), shift (per-shift batches), phase, "
                           "phase-blocked (halo-exact line windows), dilated "
                           "(one dense pass, ~25 KB of device memory per pixel; "
                           "halo-exact line windows past a 2.5 Mpx canvas, "
                           "3,647 lines at width 598)")
        elif action.dest == "flightline":
            action.nargs = "+"
            action.help = "Flightline ENVI IMG path(s)"
        elif action.dest == "dtype":
            action.default = "float32"     # the FCN's trunk is f32 unless asked
    return p


def _dtype(name):
    import torch
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _run_campaign(args):
    """N flightlines -> N saliency maps, scenes batched through
    ``fcn_phase_saliency_batch``."""
    import numpy as np
    import torch
    from ..core import envi as envi_io
    from .fcn_pipeline import (fcn_phase_saliency, fcn_phase_saliency_batch,
                               fcn_phase_saliency_blocked, load_saliency_model,
                               unblocked_limits)
    from .preprocess import norm_for_model, preprocess_ch4

    if not args.weights or not os.path.isfile(args.weights):
        print(f"[INFO] Model weights not found at {args.weights}, exiting.")
        return 1
    dtype = _dtype(args.dtype)
    model = load_saliency_model(args.weights, dtype=dtype, device=args.device)
    dev = next(model.parameters()).device
    mean, std = norm_for_model(args.model)
    _, max_px = unblocked_limits()
    os.makedirs(args.output or ".", exist_ok=True)

    paths = list(args.flightline)
    for i in range(0, len(paths), args.scene_batch):
        group = paths[i:i + args.scene_batch]
        t0 = time.time()
        bands, metas = [], []
        for pth in group:
            img = envi_io.open_envi(pth)
            bands.append(np.asarray(img.read_band(args.band - 1), dtype=np.float32))
            metas.append(img.metadata)
        hmax = max(b.shape[0] for b in bands)
        wmax = max(b.shape[1] for b in bands)
        xs = torch.zeros((len(group), hmax, wmax), dtype=dtype, device=dev)
        for k, b in enumerate(bands):
            xs[k, :b.shape[0], :b.shape[1]] = preprocess_ch4(
                torch.tensor(b, device=dev).to(dtype), mean, std)
        if hmax * wmax * len(group) > max_px:
            print(f"[INFO] {len(group)}x{hmax}x{wmax} exceeds the batched "
                  "memory budget; running scenes singly")
            sal_fn = (fcn_phase_saliency_blocked if hmax * wmax > max_px
                      else fcn_phase_saliency)
            sals = [sal_fn(model, x) for x in xs]
        else:
            sals = fcn_phase_saliency_batch(model, xs)
        for k, (pth, b) in enumerate(zip(group, bands)):
            sal = sals[k][:b.shape[0], :b.shape[1]].float().cpu().numpy()
            sal = np.where(b == -9999.0, np.float32(-9999.0), sal)
            stem = os.path.splitext(os.path.basename(pth))[0]
            outf = os.path.join(args.output, f"{stem}_saliency")
            meta = {"data ignore value": -9999}
            if "map info" in metas[k]:
                meta["map info"] = metas[k]["map info"]
            envi_io.save_envi(outf + ".hdr", sal, metadata=meta, interleave="bip")
            print(f"[INFO] Saved to {outf}")
        print(f"[INFO] batch of {len(group)} scenes in {time.time() - t0:.1f}s")
    print("Done!")
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if len(args.flightline) > 1:
        if args.method not in ("auto", "phase") or args.scale != 32:
            print("[ERROR] several flightlines run the phase path (scale 32)",
                  file=sys.stderr)
            return 2
        return _run_campaign(args)
    args.flightline = args.flightline[0]
    from .fcn_pipeline import fcn_saliency_image, saliency_model

    def fn(band, sd):
        model = saliency_model(sd, _dtype(args.dtype), args.device)
        return fcn_saliency_image(band, model, model_name=args.model,
                                  scale=args.scale, batch=args.batch,
                                  method=args.method,
                                  device=args.device).cpu().numpy()

    return _run(args, fn)


if __name__ == "__main__":
    sys.exit(main())
