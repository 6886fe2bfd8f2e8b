"""Training harness: SAM GoogLeNet on tiled methane data.

Port of the JAX package's ``train/train.py``. Reference
(cnn/training/experiment_script_all.py): per-epoch train loop with SAM
two-pass steps, validation pass, weights saved every 5 epochs, loss CSVs,
and a post-training PR-curve -> best-F1 threshold with classification
reports (:434-510).

Checkpoints are the JAX package's ``.npz`` layout (``params/...``,
``batch_stats/...``, aux heads included), so a checkpoint of either package
resumes in the other. The threshold search and the report are numpy
(no scikit-learn). ``TrainConfig(devices=N)`` trains data-parallel over N
ranks (:mod:`.ddp`).
"""

from __future__ import annotations

import csv
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import (flax_to_torch_state_dict, save_weights,
                              torch_state_dict_to_flax, unflatten)
from ..models.googlenet import GoogLeNet
from .data import (TiledDataset, TRAIN_CAMPAIGN_NORM, load_labels_csv,
                   loss_weights_for)
from .sam import (make_inner_optimizer, make_sam_train_step, make_sgd_train_step,
                  step_lr, weighted_cross_entropy)

__all__ = ["TrainConfig", "train_experiment", "evaluate_threshold",
           "precision_recall_curve", "classification_report", "make_model",
           "save_checkpoint", "load_checkpoint", "load_into",
           "save_checkpoint_pt", "load_checkpoint_pt"]


class TrainConfig:
    def __init__(self, dataroot, campaign, lr=1e-4, augment="default",
                 crop=256, epochs=100, outroot="cnn_output", use_sam=True,
                 batch_size=16, train_all=False, seed=0, aux_weight=0.0,
                 resume=None, start_epoch=0, devices=None, device="cuda"):
        """``resume``: a weights .npz from a previous run of either package:
        params and batch_stats are restored before training (the reference
        resumes by loading the every-5-epochs torch.save,
        experiment_script_all.py:406-408). ``start_epoch`` continues the
        StepLR schedule from that epoch. ``device``: where the model and
        its steps run.

        ``devices`` > 1: data-parallel over that many ranks (:mod:`.ddp`),
        each on its own card for ``device="cuda"`` (NCCL; raises with fewer
        cards), all on the CPU or on one card for ``"cpu"`` or ``"cuda:0"``
        (gloo). Each step is the global batch's, as the JAX package's
        GSPMD step: its rows split over the ranks, BatchNorm over the
        global batch, the global weighted loss. A batch the ranks do not
        divide (the short last one) runs whole on every rank. Dropout masks
        come from a generator seeded with ``seed + rank``. Rank 0 alone
        evaluates and writes the files."""
        self.__dict__.update(locals())
        del self.__dict__["self"]


def make_model(seed: int = 0, device="cpu") -> GoogLeNet:
    """The trainer's network: GoogLeNet-1ch with aux heads, initialised
    from a ``torch.Generator`` seeded with ``seed``, in train mode."""
    gen = torch.Generator().manual_seed(seed)
    return GoogLeNet(num_classes=2, aux_logits=True, generator=gen).to(device).train()


def _flax_tree(model):
    return torch_state_dict_to_flax(model.state_dict())


def save_checkpoint(path, model):
    """Flattened npz checkpoint in the JAX package's layout
    (``params/...``, ``batch_stats/...``; role of torch.save(state_dict),
    experiment_script_all.py:406-408)."""
    save_weights(path, _flax_tree(model))


def load_checkpoint(path):
    """npz checkpoint -> nested ``{"params": ..., "batch_stats": ...}`` with
    numpy leaves (the JAX package's ``load_checkpoint`` tree)."""
    with np.load(path, allow_pickle=False) as flat:
        return unflatten({k: flat[k] for k in flat.files})


def load_into(model, tree):
    """Load a ``{"params", "batch_stats"}`` tree (aux heads included) into
    ``model``, strictly; ``num_batches_tracked`` restarts at 0."""
    sd = flax_to_torch_state_dict(tree, aux_heads=True)
    model.load_state_dict(sd)
    return model


def save_checkpoint_pt(path, model):
    """``torch.save`` checkpoint with the contents of the JAX package's
    orbax one (``train.py:87-106``): params and batch_stats in the Flax
    tree layout, as tensors; no optimizer momentum."""
    tree = _flax_tree(model)

    def to_t(node):
        return {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
                for k, v in node.items()}

    torch.save(to_t(tree), path)
    return path


def load_checkpoint_pt(path):
    """Inverse of :func:`save_checkpoint_pt`: the tree with numpy leaves."""
    tree = torch.load(path, map_location="cpu", weights_only=True)

    def to_np(node):
        return {k: to_np(v) if isinstance(v, dict) else v.numpy()
                for k, v in node.items()}

    return to_np(tree)


def _to_device(images, labels, dev, dtype=torch.float32):
    """(N, H, W, 1) float32 host batch -> NCHW ``dtype`` (the model's) on
    ``dev``, through pinned memory on a card, so the copy does not wait
    for the queued steps."""
    x = torch.from_numpy(np.ascontiguousarray(images[..., 0]))[:, None]
    y = torch.from_numpy(np.asarray(labels, np.int64))
    if dev.type == "cuda":
        x, y = (x.pin_memory().to(dev, non_blocking=True),
                y.pin_memory().to(dev, non_blocking=True))
    return x.to(dtype), y


@torch.no_grad()
def _predict_probs(model, dataset, batch_size, dev):
    """Positive-class probabilities in eval mode; the model goes back to
    train mode after."""
    model.eval()
    dtype = next(model.parameters()).dtype
    probs, labels = [], []
    try:
        for images, labs in dataset.batches(batch_size, shuffle=False):
            x, _ = _to_device(images, labs, dev, dtype)
            probs.append(torch.softmax(model(x), -1)[:, 1].cpu().numpy())
            labels.append(labs)
    finally:
        model.train()
    return np.concatenate(probs), np.concatenate(labels)


def precision_recall_curve(labels, scores):
    """scikit-learn's ``precision_recall_curve`` for binary labels
    (positive class 1; ``drop_intermediate=False``): one point per distinct
    score, in increasing threshold order, then precision 1 and recall 0.
    Without a positive label the recall is 1 at every threshold."""
    y = np.asarray(labels) == 1
    s = np.asarray(scores)
    order = np.argsort(s, kind="stable")[::-1]
    s, y = s[order], y[order].astype(np.float64)
    idx = np.r_[np.flatnonzero(np.diff(s)), s.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx - tps
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, tps / ps, 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], s[idx][::-1])


def classification_report(labels, preds):
    """scikit-learn's ``classification_report(output_dict=True,
    zero_division=0)`` for binary labels: per class present in either
    array (keys "0", "1"), precision, recall, f1-score and support, then
    accuracy, the macro and the support-weighted averages."""
    y = np.asarray(labels).astype(np.int64)
    p = np.asarray(preds).astype(np.int64)
    classes = np.union1d(y, p)
    rows = []
    report = {}
    for c in classes:
        tp = float(np.sum((y == c) & (p == c)))
        pred_n, true_n = float(np.sum(p == c)), float(np.sum(y == c))
        prec = tp / pred_n if pred_n else 0.0
        rec = tp / true_n if true_n else 0.0
        f1 = 2 * tp / (pred_n + true_n) if pred_n + true_n else 0.0
        rows.append((prec, rec, f1, true_n))
        report[str(c)] = {"precision": prec, "recall": rec, "f1-score": f1,
                          "support": true_n}
    arr = np.asarray(rows)
    report["accuracy"] = float(np.mean(y == p))
    report["macro avg"] = dict(zip(("precision", "recall", "f1-score"),
                                   map(float, arr[:, :3].mean(0))),
                               support=float(arr[:, 3].sum()))
    report["weighted avg"] = dict(zip(("precision", "recall", "f1-score"),
                                      map(float, np.average(arr[:, :3], axis=0,
                                                            weights=arr[:, 3]))),
                                  support=float(arr[:, 3].sum()))
    return report


def evaluate_threshold(probs, labels):
    """PR curve -> best-F1 threshold + report (reference:
    experiment_script_all.py:434-510)."""
    precision, recall, thresholds = precision_recall_curve(labels, probs)
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = 2 * precision * recall / (precision + recall)
    f1 = np.nan_to_num(f1[:-1])
    best = int(np.argmax(f1))
    thr = float(thresholds[best])
    report = classification_report(labels, probs >= thr)
    return dict(threshold=thr, f1=float(f1[best]),
                precision=float(precision[best]), recall=float(recall[best]),
                report=report)


def train_experiment(cfg: TrainConfig, progress=print):
    """Run a full training experiment; returns (model, expdir, metrics).

    Besides the JAX package's files, ``epoch_times.csv`` gives each epoch's
    batches, host data seconds (tile reads, crop, normalise, augment),
    device step seconds (CUDA events around each step on a card, the
    step's wall time on the CPU) and wall seconds. With ``cfg.devices`` > 1
    the ranks run in processes of their own (:mod:`.ddp`), rank 0 writing
    the files (its own times in ``epoch_times.csv``); the model returned
    is the final checkpoint loaded on the first rank's device."""
    dev = resolve_device(cfg.device)
    expname = (f"{datetime.now().strftime('%Y%m%d_%H%M%S_%f')}_"
               f"{cfg.campaign}_{cfg.augment}_"
               f"{'all' if cfg.train_all else 'train'}_{cfg.crop}")
    outdir = os.path.join(cfg.outroot, expname)
    weightdir = os.path.join(outdir, "weights")
    os.makedirs(weightdir, exist_ok=True)
    world = cfg.devices or 1
    if world == 1:
        return _train(cfg, expname, outdir, dev, make_model, progress)

    from . import ddp
    devices = ddp.rank_devices(cfg.device, world)
    progress(f"Data-parallel over {world} ranks on {[str(d) for d in devices]} "
             f"({ddp.backend_for(devices)})")
    ddp.spawn(_train_rank, world, cfg.device, os.path.join(outdir, ".rendezvous"),
              args=(cfg, expname, outdir, make_model, progress is print))
    with open(os.path.join(outdir, "metrics.json")) as f:
        metrics = json.load(f)
    final = os.path.join(weightdir, f"final_{expname}_weights.npz")
    model = load_into(make_model(cfg.seed, devices[0]), load_checkpoint(final))
    return model, outdir, metrics


def _train_rank(rank, world, dev, cfg, expname, outdir, make, verbose):
    """One rank of a data-parallel experiment (:func:`.ddp.spawn`)."""
    _train(cfg, expname, outdir, dev, make,
           print if verbose and rank == 0 else (lambda *a: None), rank, world)


def _train(cfg, expname, outdir, dev, make, progress, rank=0, world=1):
    """The experiment's loop on this rank. With ``world`` > 1 the model is
    wrapped in DDP and each batch split by :func:`.ddp.shard_batch`; rank
    0 alone evaluates and writes, the others waiting at a barrier."""
    weightdir = os.path.join(outdir, "weights")
    mean, std = TRAIN_CAMPAIGN_NORM[cfg.campaign]
    mode_csv = "data_labels.csv" if cfg.train_all else "train.csv"
    train_rows = load_labels_csv(os.path.join(cfg.dataroot, cfg.campaign,
                                              mode_csv))
    val_rows = load_labels_csv(os.path.join(cfg.dataroot, cfg.campaign,
                                            "test.csv"))
    weights = loss_weights_for(train_rows)
    progress(f"Using class weights {weights}")

    train_ds = TiledDataset(os.path.join(cfg.dataroot, cfg.campaign),
                            train_rows, mean, std, cfg.crop, cfg.augment,
                            seed=cfg.seed)
    val_ds = TiledDataset(os.path.join(cfg.dataroot, cfg.campaign),
                          val_rows, mean, std, cfg.crop, "augA")

    model = make(cfg.seed, dev)
    if cfg.resume:
        progress(f"Resuming weights from {cfg.resume}")
        load_into(model, load_checkpoint(cfg.resume))
    net = model
    if world > 1:
        import torch.distributed as dist
        from . import ddp
        net = ddp.wrap(model, dev)
    optimizer = make_inner_optimizer(model.parameters())
    dtype = next(model.parameters()).dtype
    wce = torch.tensor(weights, dtype=dtype, device=dev)
    step = (make_sam_train_step(net, optimizer, wce, aux_weight=cfg.aux_weight)
            if cfg.use_sam else
            make_sgd_train_step(net, optimizer, wce, aux_weight=cfg.aux_weight))
    # dropout masks: one generator on the step's device, seeded by the run
    # and the rank
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + rank)

    batch_losses = [["epoch", "batch", "loss"]]
    train_epoch_losses = [["epoch", "mean train loss"]]
    val_epoch_losses = [["epoch", "mean val loss"]]
    epoch_times = [["epoch", "batches", "data_s", "step_s", "wall_s"]]

    for epoch in range(cfg.start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        lr = step_lr(cfg.lr, cfg.epochs, epoch)
        losses, marks, data_s, step_s = [], [], 0.0, 0.0
        batches = train_ds.batches(cfg.batch_size, shuffle=True)
        while True:
            td = time.perf_counter()
            try:
                images, labels = next(batches)
            except StopIteration:
                break
            group = None
            if world > 1:
                images, labels, group = ddp.shard_batch(images, labels, rank, world)
            data_s += time.perf_counter() - td
            x, y = _to_device(images, labels, dev, dtype)
            if dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                losses.append(step(x, y, lr, gen, group=group))
                ev[1].record()
                marks.append(ev)
            else:
                ts = time.perf_counter()
                losses.append(step(x, y, lr, gen, group=group))
                step_s += time.perf_counter() - ts
        lossf = torch.stack(losses).tolist() if losses else []
        if marks:
            step_s = sum(a.elapsed_time(b) for a, b in marks) / 1e3
        batch_losses += [[epoch, it, v] for it, v in enumerate(lossf)]
        epoch_loss = 0.0
        for v in lossf:
            epoch_loss += v
        nb = len(lossf)
        train_epoch_losses.append([epoch, epoch_loss / max(nb, 1)])
        wall_s = time.perf_counter() - t0
        epoch_times.append([epoch, nb, data_s, step_s, wall_s])
        progress(f"Epoch {epoch} took {wall_s:.1f}s "
                 f"loss {epoch_loss / max(nb, 1):.4f}")

        if rank == 0:
            # validation (reference: experiment_script_all.py:390-403)
            vloss, vb = 0.0, 0
            model.eval()
            with torch.no_grad():
                for images, labels in val_ds.batches(cfg.batch_size, shuffle=False):
                    x, y = _to_device(images, labels, dev, dtype)
                    vloss += float(weighted_cross_entropy(model(x), y, wce))
                    vb += 1
            model.train()
            val_epoch_losses.append([epoch, vloss / max(vb, 1)])

            if (epoch + 1) % 5 == 0:
                save_checkpoint(os.path.join(
                    weightdir, f"{epoch}_{expname}_weights.npz"), model)
        if world > 1:
            dist.barrier()

    metrics = None
    if rank == 0:
        for name, rows in [("batch_losses.csv", batch_losses),
                           ("epoch_losses.csv", train_epoch_losses),
                           ("val_losses.csv", val_epoch_losses),
                           ("epoch_times.csv", epoch_times)]:
            with open(os.path.join(outdir, name), "w", newline="") as f:
                csv.writer(f).writerows(rows)

        # post-training threshold selection on train, report on train/val
        tr_probs, tr_labels = _predict_probs(model, train_ds, cfg.batch_size, dev)
        metrics = evaluate_threshold(tr_probs, tr_labels)
        va_probs, va_labels = _predict_probs(model, val_ds, cfg.batch_size, dev)
        metrics["val_report"] = evaluate_threshold(va_probs, va_labels)["report"]
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2, default=str)
        save_checkpoint(os.path.join(weightdir, f"final_{expname}_weights.npz"), model)
    if world > 1:
        dist.barrier()
    return model, outdir, metrics
