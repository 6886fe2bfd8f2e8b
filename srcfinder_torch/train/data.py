"""Tile dataset + augmentations for classifier training.

Reference (cnn/training/experiment_script_all.py:87-174): CSV-driven tile
list, band 4 of 256x256 GeoTIFF tiles, label -1/0 -> 0 and 1 -> 1,
ClampMethaneTile + CenterCrop + Normalize, augA (none) / augB (flips) /
augC (flips + affine +-180deg, 10% translate, bilinear).

Tiles are read from GeoTIFF (.tif/.tiff via core.geotiff — the
reference's native tile format, band 4 = the CMF CH4 band), .npy
((H, W) or (H, W, B) / (B, H, W)), or ENVI; band selection matches the
reference's ``read(4)``. Augmentations run on host numpy with a seeded
generator; the compute-heavy path (the model) is the device side.

A numpy-only copy of the JAX package's ``train/data.py``: the seeded
generator is consumed in the same order (shuffle, then flips, then the
affine draws), so the batches are bit-equal to the JAX package's. They
stay host numpy, (N, H, W, 1); the trainer moves them to the device.
"""

from __future__ import annotations

import csv
import os

import numpy as np
from scipy import ndimage

__all__ = ["TRAIN_CAMPAIGN_NORM", "load_tile_band", "TiledDataset",
           "load_labels_csv", "loss_weights_for", "augment_batch",
           "center_crop", "clamp_normalize"]

#: training normalization constants per campaign
#: (reference: experiment_script_all.py:218-237)
TRAIN_CAMPAIGN_NORM = {
    "CalCH4_v8": (140.6399, 237.5434),
    "COVID_QC": (110.6390, 183.9152),
    "Permian_QC": (100.2635, 158.7060),
    "GAO_Denver_QC": (134.0613, 216.1759),
    "GAO_Penn_ALL": (329.4639, 519.1670),
}


def load_labels_csv(path):
    """[(tilepath, label), ...] skipping the header row
    (reference: experiment_script_all.py:202-212)."""
    rows = []
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            if row:
                rows.append((row[0], int(row[1])))
    return rows


def loss_weights_for(rows):
    """[1, neg/pos] class weights (reference:
    experiment_script_all.py:214-215)."""
    labels = [1 if lab == 1 else 0 for _, lab in rows]
    pos = sum(labels)
    return [1.0, (len(labels) - pos) / max(pos, 1)]


def load_tile_band(path, band: int = 4):
    """Load one band of a tile: GeoTIFF, .npy, or ENVI
    (reference reads rasterio band 4, experiment_script_all.py:120-121)."""
    if path.endswith((".tif", ".tiff")):
        from ..core.geotiff import read_geotiff
        arr, _ = read_geotiff(path)
        if arr.ndim == 2:
            return arr.astype(np.float32)
        return arr[..., band - 1].astype(np.float32)
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 2:
            return arr.astype(np.float32)
        if arr.shape[0] <= 8:            # (B, H, W)
            return arr[band - 1].astype(np.float32)
        return arr[..., band - 1].astype(np.float32)
    from ..core.envi import open_envi
    img = open_envi(path)
    return np.asarray(img.open_memmap(interleave="bip")[..., band - 1],
                      dtype=np.float32)


def center_crop(x, crop: int):
    h, w = x.shape[-2], x.shape[-1]
    # torch CenterCrop pads with 0 when the image is smaller
    if h < crop or w < crop:
        ph, pw = max(0, crop - h), max(0, crop - w)
        x = np.pad(x, [(0, 0)] * (x.ndim - 2)
                   + [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)])
        h, w = x.shape[-2], x.shape[-1]
    r0 = (h - crop) // 2
    c0 = (w - crop) // 2
    return x[..., r0:r0 + crop, c0:c0 + crop]


def clamp_normalize(x, mean, std, ch4min=0.0, ch4max=4000.0):
    """(reference: experiment_script_all.py:70-86 ClampMethaneTile 1-ch
    path + Normalize)"""
    return (np.clip(x, ch4min, ch4max) - mean) / std


def augment_batch(x, rng: np.random.Generator, augment: str = "augA"):
    """Apply augA/augB/augC to a (N, H, W) batch
    (reference: experiment_script_all.py:132-174)."""
    if augment in ("augA", "default"):
        return x
    out = x.copy()
    n = x.shape[0]
    if augment in ("augB", "augC"):
        hflip = rng.random(n) < 0.5
        vflip = rng.random(n) < 0.5
        out[hflip] = out[hflip, :, ::-1]
        out[vflip] = out[vflip, ::-1, :]
    if augment == "augC":
        for i in range(n):
            deg = rng.uniform(-180, 180)
            h, w = out[i].shape
            tr = (rng.uniform(-0.1, 0.1) * h, rng.uniform(-0.1, 0.1) * w)
            out[i] = _affine(out[i], deg, tr)
    return out


def _affine(img, deg, translate):
    """Rotation about the center + translation, bilinear
    (torchvision RandomAffine semantics)."""
    theta = np.deg2rad(deg)
    c, s = np.cos(theta), np.sin(theta)
    mat = np.array([[c, -s], [s, c]])
    center = (np.asarray(img.shape) - 1) / 2.0
    offset = center - mat @ center - np.asarray(translate)
    return ndimage.affine_transform(img, mat, offset=offset, order=1,
                                    mode="constant", cval=0.0)


class TiledDataset:
    """CSV-driven tile classification dataset (reference:
    TiledDatasetClass1Ch, experiment_script_all.py:87-130)."""

    def __init__(self, dataroot, rows, mean, std, crop: int = 256,
                 augment: str = "augA", band: int = 4, seed: int = 0):
        self.dataroot = dataroot
        self.rows = rows
        self.mean, self.std = mean, std
        self.crop = crop
        self.augment = augment
        self.band = band
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.rows)

    def _tile_path(self, p):
        parts = os.path.normpath(p).split(os.sep)[-3:]
        return os.path.join(self.dataroot, *parts)

    def batches(self, batch_size: int, shuffle: bool = True):
        """Yield (images (N, H, W, 1) float32, labels (N,) int32)."""
        order = np.arange(len(self.rows))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            imgs, labs = [], []
            for j in idx:
                p, lab = self.rows[j]
                x = load_tile_band(self._tile_path(p), self.band)
                x = center_crop(x, self.crop)
                x = clamp_normalize(x, self.mean, self.std)
                imgs.append(x)
                labs.append(1 if lab == 1 else 0)
            batch = np.stack(imgs)
            batch = augment_batch(batch, self.rng, self.augment)
            yield batch[..., None].astype(np.float32), np.asarray(labs, np.int32)
