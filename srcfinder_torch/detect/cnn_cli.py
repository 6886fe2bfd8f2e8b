"""CLI: dense CNN saliency map (reference: cnn/cnn_pred_pipeline.py:62-121).

usage: python -m srcfinder_torch.detect.cnn_cli FLIGHTLINE -m COVID_QC
           -w weights.npz [-b 4096] [--method exact|fast]
           [--dtype bfloat16|float32] [--device cuda|cpu] -o OUT

Differences from the reference CLI: ``--gpus`` is absent (one card);
``--weights`` points at a checkpoint file, ``.npz`` in the Flax layout or
a ``.pt`` state dict (the reference resolves cnn/models/<model>.pt, which
this repo does not ship).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        description="Generate a flightline saliency map with a CNN (PyTorch/CUDA).")
    p.add_argument("flightline", type=str, help="Flightline ENVI IMG path")
    p.add_argument("--model", "-m", default="COVID_QC",
                   choices=["COVID_QC", "CalCH4_v8", "Permian_QC",
                            "multi_256", "multi_64"],
                   help="Model name (sets normalization constants)")
    p.add_argument("--weights", "-w", default=None,
                   help=".pt (torch) or .npz (flax) checkpoint path")
    p.add_argument("--band", "-n", type=int, default=1,
                   help="1-based band to read")
    p.add_argument("--batch", "-b", type=int, default=4096,
                   help="windows per device batch")
    p.add_argument("--superbatch", type=int, default=64,
                   help="accepted for the JAX package's command line; has no "
                        "effect (the batch loop runs on one stream)")
    p.add_argument("--dim", type=int, default=256, help="window size")
    p.add_argument("--method", default="exact", choices=["exact", "fast"],
                   help="exact per-window forwards, or amortized dense")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="trunk compute dtype")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (cuda raises without a card)")
    p.add_argument("--output", "-o", default=".", help="output directory")
    return p


def load_weights(path):
    """``.pt`` (torch state dict) or ``.npz`` (flattened Flax tree) -> the
    port's canonical ``state_dict``."""
    from ..models.convert import load_weights as _load
    return _load(path)


def save_weights(path, variables):
    """Flax variables tree -> flattened ``.npz`` (readable by both packages)."""
    from ..models.convert import save_weights as _save
    _save(path, variables)


def _run(args, saliency_fn):
    import numpy as np
    from ..core import envi as envi_io

    print("[STEP] MODEL INITIALIZATION")
    if not args.weights or not os.path.isfile(args.weights):
        print(f"[INFO] Model weights not found at {args.weights}, exiting.")
        return 1
    sd = load_weights(args.weights)

    print("[STEP] MODEL PREDICTION")
    img = envi_io.open_envi(args.flightline)
    band = np.asarray(img.read_band(args.band - 1), dtype=np.float32)
    t0 = time.time()
    sal = np.asarray(saliency_fn(band, sd))
    print(f"[INFO] saliency computed in {time.time() - t0:.1f}s")

    print("[STEP] RESULT EXPORT")
    os.makedirs(args.output or ".", exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.flightline))[0]
    outf = os.path.join(args.output, f"{stem}_saliency")
    meta = {"data ignore value": -9999}
    if "map info" in img.metadata:
        meta["map info"] = img.metadata["map info"]
    envi_io.save_envi(outf + ".hdr", sal.astype(np.float32), metadata=meta,
                      interleave="bip")
    print(f"[INFO] Saved to {outf}")
    print("Done!")
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch
    from ..models.googlenet import GoogLeNet
    from .cnn_pipeline import cnn_saliency_image

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    def fn(band, sd):
        model = GoogLeNet(num_classes=2)
        model.load_state_dict(sd)
        return cnn_saliency_image(band, model, model_name=args.model,
                                  dim=args.dim, batch=args.batch,
                                  method=args.method, dtype=dtype,
                                  device=args.device).cpu().numpy()

    return _run(args, fn)


if __name__ == "__main__":
    sys.exit(main())
