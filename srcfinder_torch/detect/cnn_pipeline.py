"""Dense sliding-window CNN saliency in PyTorch.

Port of the JAX package's ``detect/cnn_pipeline.py`` (reference:
cnn/cnn_pred_pipeline.py), which classifies a 256x256 zero-padded window
centred on every pixel. Two modes:

- ``exact`` (:func:`cnn_window_saliency`): one GoogLeNet forward per window,
  window-edge conv padding identical to the reference. The padded scene is
  on the device once; each batch takes its windows' origins in it and runs
  one batched forward, all on one stream with no host sync until the end.
  ``trunk=`` picks how the trunk runs:

  - ``"stage12"`` (default): ``fused_stage12_gather`` (its kernel reads
    each window's halo from the padded scene: the windows are never
    written out) -> ``trunk_s3`` -> ``trunk_s45`` -> fc, on hand kernels
    only, the one of the two kernel routes with less device time on the
    H100 (PERF.md);
  - ``"segments"``: the windows gathered, conv1 (cuDNN) -> ``trunk_s23``
    -> ``trunk_s45`` -> fc, the JAX package's last fused design;
  - ``"plain"``: the windows gathered, the model's own forward.

  The kernel routes launch the CUDA kernels of ``ops/trunk_fuse.py`` on a
  card and their plain versions on the CPU.
- ``fast`` (:func:`cnn_fast_saliency`): the head is a global average pool
  and a linear layer, so a window's logits are fc(mean of the trunk
  features over its 8x8 footprint); one trunk forward per 32x32 shift
  phase and a box filter cover all windows. It differs from ``exact`` near
  window borders (full-image convs see real neighbours where the
  reference's crops see zero padding).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.fcn import fc_logits
from ..models.googlenet import GoogLeNet, fold_inference
from ..ops.trunk_fuse import (fused_stage12_gather, pack_params, stage12_params, trunk_s3,
                              trunk_s23, trunk_s45, trunk_segment_params)
from .preprocess import norm_for_model, preprocess_ch4

__all__ = ["reference_pad", "cnn_window_saliency", "cnn_window_saliency_sharded",
           "cnn_fast_saliency", "cnn_saliency_image", "TRUNKS"]

TRUNKS = ("segments", "stage12", "plain")


def reference_pad(img, dim: int = 256):
    """transforms.Pad([dim//2, dim//2, dim//2-1, dim//2-1]): left/top
    dim//2, right/bottom dim//2-1 (reference: cnn_pred_pipeline.py:45)."""
    h = dim // 2
    return F.pad(img, (h, h - 1, h, h - 1))


class _WindowForward:
    """Windows of side ``dim`` at ``origins`` (B, 2) (row, col) of the
    padded scene -> (B,) class-1 probability in f32, through the trunk
    route ``trunk``; the kernel routes' weights are taken from the folded
    model and packed once, on its device and dtype."""

    def __init__(self, model: GoogLeNet, trunk: str):
        if trunk not in TRUNKS:
            raise ValueError(f"unknown trunk {trunk!r}; use one of {TRUNKS}")
        self.model, self.trunk = model, trunk
        sd = model.state_dict()
        if trunk == "stage12":
            self.p12 = pack_params("fused_stage12", stage12_params(sd))
            self.p3 = pack_params("trunk_s3", trunk_segment_params(sd, "s3"))
        elif trunk == "segments":
            self.p23 = pack_params("trunk_s23", trunk_segment_params(sd, "s23"))
        if trunk != "plain":
            self.p45 = pack_params("trunk_s45", trunk_segment_params(sd, "s45"))

    def __call__(self, padded, origins, dim):
        m = self.model
        if self.trunk == "stage12":
            x = trunk_s3(fused_stage12_gather(padded, origins, dim, self.p12), self.p3)
        else:
            wins = padded.unfold(0, dim, 1).unfold(1, dim, 1)[origins[:, 0], origins[:, 1]]
            if self.trunk == "plain":
                return torch.softmax(m(wins[:, None]), dim=-1)[:, 1].float()
            x = trunk_s23(m(wins[:, None], stage=1).permute(0, 2, 3, 1).contiguous(), self.p23)
        logits = m.fc(trunk_s45(x, self.p45))
        return torch.softmax(logits, dim=-1)[:, 1].float()


@torch.inference_mode()
def cnn_window_saliency(model: GoogLeNet, img, dim: int = 256, batch: int = 512,
                        trunk: str = "stage12", progress=None):
    """Exact dense sliding-window class-1 probability map.

    img: (H, W) preprocessed tensor. Returns (H, W) f32 on its device.

    Windows are taken in row-major order: pixel (r, c)'s window starts at
    row r, column c of the padded scene. The last batch is padded with
    copies of the scene's last window, whose outputs are discarded.
    """
    h, w = img.shape
    n = h * w
    out = torch.empty(n, dtype=torch.float32, device=img.device)
    _window_range(_WindowForward(model, trunk), reference_pad(img, dim), w, n, 0, n,
                  dim, batch, out, progress)
    return out.reshape(h, w)


def _window_range(forward, padded, w: int, n: int, i0: int, i1: int, dim: int,
                  batch: int, out, progress=None):
    """Windows ``[i0, i1)`` of the scene's ``n`` (row-major over a width
    ``w``) through ``forward`` in batches of ``batch`` from ``i0``, into
    ``out[0:i1 - i0]``. A short last batch is padded with copies of the
    scene's last window, whose outputs are discarded."""
    for i in range(i0, i1, batch):
        take = min(batch, i1 - i)
        idx = torch.arange(i, i + batch, device=padded.device).clamp_(max=n - 1)
        out[i - i0:i - i0 + take] = forward(
            padded, torch.stack([idx // w, idx % w], dim=1), dim)[:take]
        if progress is not None:
            progress(i + take, n)


@torch.inference_mode()
def cnn_window_saliency_sharded(model: GoogLeNet, img, mesh, dim: int = 256,
                                batch: int = 512, trunk: str = "stage12"):
    """:func:`cnn_window_saliency` with the windows split over ``mesh`` (a
    list of devices, :mod:`srcfinder_torch.parallel`): the JAX package's
    ``cnn_window_saliency_sharded``, in place of the reference's
    ``nn.DataParallel`` on the exact path (cnn_pred_pipeline.py:113-116).

    Each device takes a contiguous range of the row-major windows, whole
    batches of ``batch`` (the batches split as ``torch.tensor_split``
    does), so every batch is the one the single-device call runs, the
    scene's last window padding the last. The model, the padded scene and
    each trunk route's packed kernel parameters replicate, one set per
    device; each shard runs :func:`_window_range`. Per-window outputs equal
    the single-device call's. Returns (H, W) f32 on ``img``'s device.
    """
    from ..parallel.mesh import as_mesh, batch_ranges, gather, replicate, run_shards

    mesh = as_mesh(mesh)
    h, w = img.shape
    n = h * w
    nb = -(-n // batch)
    ranges = [(b0 * batch, min(b1 * batch, n)) for b0, b1 in batch_ranges(nb, len(mesh))
              if b1 > b0]
    models = replicate(model, mesh)
    forwards = replicate(lambda dev: _WindowForward(models[dev], trunk), mesh)
    padded = replicate(reference_pad(img, dim), mesh)

    def shard(k, dev):
        i0, i1 = ranges[k]
        out = torch.empty(i1 - i0, dtype=torch.float32, device=dev)
        _window_range(forwards[dev], padded[dev], w, n, i0, i1, dim, batch, out)
        return out

    return gather(run_shards(mesh, shard, len(ranges)), img.device).reshape(h, w)


#: shift phases per model call in the fast mode
_FAST_PHASES_PER_CALL = 32


@torch.inference_mode()
def cnn_fast_saliency(model: GoogLeNet, img, dim: int = 256):
    """Amortized dense saliency: 1024 phase forwards, batched
    ``_FAST_PHASES_PER_CALL`` to a model call, instead of H*W window
    forwards.

    A window starting at padded pixel (r, c) with r = top + 32a,
    c = left + 32b global-average-pools exactly the (dim/32)^2 trunk
    features at [a, a + dim/32) x [b, b + dim/32) of the phase view
    canvas[top:top+hv, left:left+wv], so one trunk forward per phase, a
    cumulative-sum box filter and the fc cover all of the phase's windows.
    """
    s = 32
    fw = dim // s                                    # feature-window width
    h, w = img.shape
    padded = reference_pad(img, dim)                 # (h+dim-1, w+dim-1)
    k_h, k_w = -(-h // s), -(-w // s)
    hv = s * k_h + (dim - s)
    wv = s * k_w + (dim - s)
    canvas = F.pad(padded, (0, max(0, s - 1 + wv - padded.shape[1]),
                            0, max(0, s - 1 + hv - padded.shape[0])))
    outs = []
    step = _FAST_PHASES_PER_CALL
    for p0 in range(0, s * s, step):
        views = torch.stack([canvas[t:t + hv, l:l + wv] for t, l in
                             (divmod(p, s) for p in range(p0, min(p0 + step, s * s)))])
        feats = model(views[:, None], features_only=True)      # (b, C, fh, fw)
        cs = F.pad(feats.cumsum(2).cumsum(3), (1, 0, 1, 0))
        box = (cs[:, :, fw:, fw:] - cs[:, :, :-fw, fw:] - cs[:, :, fw:, :-fw]
               + cs[:, :, :-fw, :-fw]) / (fw * fw)
        outs.append(torch.softmax(fc_logits(model, box), dim=-1)[:, :k_h, :k_w, 1])
    grid = torch.cat(outs).reshape(s, s, k_h, k_w)   # [top, left, a, b]
    # out[r, c] = grid[r % s, c % s, r // s, c // s]
    full = grid.permute(2, 0, 3, 1).reshape(k_h * s, k_w * s)
    return full[:h, :w]


def cnn_saliency_image(img, model: GoogLeNet, model_name: str = "COVID_QC",
                       dim: int = 256, batch: int = 512, nodata=-9999.0,
                       method: str = "exact", dtype=torch.float32, progress=None,
                       fused: bool = True, trunk: str = "stage12", device="cuda"):
    """Raw CH4 band -> dense CNN saliency with nodata re-stamped
    (reference: cnn_pred_pipeline.py:170-189).

    ``img``: (H, W) numpy array or tensor. ``model``: a canonical or folded
    GoogLeNet. ``fused=True`` runs the inference trunk with BatchNorm folded
    and each inception's three 1x1s as one conv
    (:func:`~srcfinder_torch.models.googlenet.fold_inference`); the kernel
    routes of ``trunk`` need it. ``dtype``: the trunk's compute dtype
    (float32 or bfloat16). Returns an (H, W) float32 tensor on ``device``.
    """
    dev = resolve_device(device)
    if fused and not (model.fused and model.folded):
        model = fold_inference(model.eval())
    model = model.to(device=dev, dtype=dtype).eval()
    mean, std = norm_for_model(model_name)
    raw = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    x = preprocess_ch4(raw.to(dtype), mean, std)
    if method == "exact":
        sal = cnn_window_saliency(model, x, dim=dim, batch=batch, trunk=trunk,
                                  progress=progress)
    elif method == "fast":
        sal = cnn_fast_saliency(model, x, dim=dim)
    else:
        raise ValueError(f"unknown method {method}")
    # stamp in f32: a bf16 trunk would round the -9999 sentinel to -9984
    return torch.where(raw == nodata, torch.full_like(raw, nodata), sal.float())
