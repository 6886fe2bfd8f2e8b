"""CLI: train a classification model on tiled methane data
(reference: cnn/training/experiment_script_all.py:251-298).

usage: python -m srcfinder_torch.train.cli DATAROOT CAMPAIGN [--lr
       --augment --crop --epochs --outroot --no-sam --batch --train-all
       --seed --resume --start-epoch --devices --device]

The JAX package's ``srcfinder-train`` arguments, plus ``--device``
(``cuda``, the default, or ``cpu``). ``--devices N`` trains data-parallel
over N ranks: one card each with ``--device cuda`` (NCCL; fewer cards
raise), all on the CPU (``--device cpu``) or on one card (``--device
cuda:0``) over gloo.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        description="Train a classification model on tiled methane data.")
    p.add_argument("dataroot", help="Directory path to dataset root")
    p.add_argument("campaign",
                   choices=["CalCH4_v8", "COVID_QC", "Permian_QC",
                            "GAO_Denver_QC", "GAO_Penn_ALL"],
                   help="Campaign to train & test on")
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--augment", default="default",
                   help="Data augmentation option (augA|augB|augC)")
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--outroot", default="cnn_output")
    p.add_argument("--no-sam", action="store_true", help="Disable SAM")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--train-all", action="store_true",
                   help="Train on the entire dataset")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="weights .npz from a previous run (of either "
                        "package) to restore")
    p.add_argument("--start-epoch", type=int, default=0,
                   help="epoch to continue the LR schedule from")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel over N ranks (one card each with "
                        "--device cuda)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:I (every rank on card I) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .train import TrainConfig, train_experiment
    cfg = TrainConfig(args.dataroot, args.campaign, lr=args.lr,
                      augment=args.augment, crop=args.crop,
                      epochs=args.epochs, outroot=args.outroot,
                      use_sam=not args.no_sam, batch_size=args.batch,
                      train_all=args.train_all, seed=args.seed,
                      resume=args.resume, start_epoch=args.start_epoch,
                      devices=args.devices, device=args.device)
    _, outdir, metrics = train_experiment(cfg)
    print(f"experiment dir: {outdir}")
    print(f"best-F1 threshold {metrics['threshold']:.3f} "
          f"F1 {metrics['f1']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
