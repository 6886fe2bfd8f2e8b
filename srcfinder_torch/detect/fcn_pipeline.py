"""FCN shift-and-stitch saliency in PyTorch.

Port of the JAX package's ``detect/fcn_pipeline.py``. The CNN-turned-FCN has
output stride 32, so full-resolution saliency is recovered by running
the flightline once per (top, left) shift of a 32x32 grid and
interlacing the 1024 downsampled outputs (reference:
cnn/fcn_pred_pipeline.py:73-95). Two evaluations of the same result:

- :func:`fcn_shift_saliency`: the literal per-shift forwards (the oracle);
- :func:`fcn_phase_saliency`: phase-deduplicated — a stride-2 stage only
  distinguishes shifts modulo its cumulative stride, so each trunk stage
  runs once per distinct phase (4+16+64+256+1024 stage evaluations
  instead of 1024 full forwards). The "wide" layout runs each stage as
  four full-width batches, one per sub-phase digit, over all maps of the
  previous level.

The convolutions go to cuDNN through ``torch.nn.functional.conv2d``; the
phase translate and the stitch are plain tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.convert import load_weights
from ..models.fcn import fc_logits
from ..models.googlenet import GoogLeNet, fold_inference
from .preprocess import norm_for_model, preprocess_ch4

__all__ = ["fcn_shift_saliency", "fcn_phase_saliency", "stitch_stack",
           "divisibility_pad", "load_saliency_model", "fcn_saliency_image"]

#: Line and pixel counts above which the JAX package reroutes the phase
#: path through its halo-blocked variant. Kept as limits until the blocked
#: path is ported (ROADMAP: modules to port, item 4): a larger scene raises.
MAX_UNBLOCKED_LINES = 7680
MAX_UNBLOCKED_PX = 5_000_000


def divisibility_pad(img, scale: int):
    """Pad bottom/right so dims are divisible by ``scale``. Reproduces the
    reference quirk of adding a FULL extra ``scale`` when already
    divisible (fcn_pred_pipeline.py:47-51 pads ``scale - dim % scale``)."""
    h, w = img.shape
    return F.pad(img, (0, scale - (w % scale), 0, scale - (h % scale)))


def _canvas(img, scale: int):
    padded = divisibility_pad(img, scale)
    return F.pad(padded, (scale, scale, scale, scale))


def stitch_stack(fl_shape, preds, scale: int = 32):
    """Interlace the (scale*scale, h, w) shift outputs back to full
    resolution and center-crop (reference: fcn_pred_pipeline.py:73-95).

    ``preds`` must be ordered by shift index i = top*scale + left.
    """
    s = scale
    S, h, w = preds.shape
    if S != s * s:
        raise ValueError(f"expected {s * s} shift maps, got {S}")
    grid = preds.reshape(s, s, h, w).flip(0, 1)     # phase = s-1-top, s-1-left
    stitched = grid.permute(2, 0, 3, 1).reshape(h * s, w * s)
    return stitched[s // 2: fl_shape[0] + s // 2,
                    s // 2: fl_shape[1] + s // 2]


@torch.inference_mode()
def fcn_shift_saliency(model: GoogLeNet, img, scale: int = 32,
                       batch: int = 16):
    """Full shift-and-stitch saliency for one preprocessed flightline.

    img: (H, W) already clamp+normalized tensor. Returns (H, W) saliency.
    """
    h0, w0 = img.shape
    canvas = _canvas(img, scale)
    hp = canvas.shape[0] - scale
    wp = canvas.shape[1] - scale
    nshift = scale * scale
    outs = []
    for i in range(0, nshift, batch):
        views = torch.stack([canvas[scale - t: scale - t + hp,
                                    scale - l: scale - l + wp]
                             for t, l in (divmod(k, scale)
                                          for k in range(i, min(i + batch, nshift)))])
        feats = model(views[:, None], features_only=True)
        outs.append(torch.softmax(fc_logits(model, feats), dim=-1)[..., 1])
    return stitch_stack((h0, w0), torch.cat(outs, dim=0), scale)


def _background_constants(model: GoogLeNet, dtype, device):
    """Per-level background feature vectors: the trunk's response to the
    zero canvas (BatchNorm makes zero input map to a nonzero constant
    field, so translated-in background must use these, not zeros).
    Returns the fill for the INPUT of stages 1..5, each shaped (C,)."""
    x = torch.zeros((1, 1, 64, 64), dtype=dtype, device=device)
    consts = [torch.zeros((1,), dtype=dtype, device=device)]
    for stage in (1, 2, 3, 4):
        x = model(x, stage=stage)
        h, w = x.shape[2], x.shape[3]
        consts.append(x[0, :, h // 2, w // 2])
    return consts


def _translate_all(feats, p: int, fill):
    """Translate (N, C, h, w) maps down/right by (p // 2, p % 2) in {0, 1},
    filling the entering rows/cols with the level's background constant
    (equivalent to starting the shift window one stride earlier)."""
    dt, dl = p // 2, p % 2
    if dt == 0 and dl == 0:
        return feats
    f = fill[None, :, None, None]
    pad = F.pad(feats - f, (dl, 0, dt, 0))
    return pad[:, :, :feats.shape[2], :feats.shape[3]] + f


def _phase_order(scale: int) -> np.ndarray:
    """Phase-tree index -> shift index permutation: digits (dt_k, dl_k)
    appended per level, t = sum dt_k * 2^(k-1), l likewise; preds must
    be ordered by i = t * scale + l for stitch_stack."""
    n = np.arange(scale * scale)
    t = np.zeros_like(n)
    l = np.zeros_like(n)
    for k in range(5):                      # digits, last level = low base
        p = (n // (4 ** (4 - k))) % 4       # level k+1's digit
        t += (p // 2) * (1 << k)
        l += (p % 2) * (1 << k)
    order = np.empty(scale * scale, dtype=np.int64)
    order[t * scale + l] = n
    return order


def _phase_order_wide(scale: int) -> np.ndarray:
    """Stitch permutation for the phase-major (wide) layout: the wide pass
    appends each level's phase digit at the LOW end of the index, i.e. the
    base-4 digit reversal of the parent-major tree index; compose that
    reversal with :func:`_phase_order`."""
    n = np.arange(scale * scale)
    rev = np.zeros_like(n)
    m = n.copy()
    for _ in range(5):
        rev = rev * 4 + (m % 4)
        m //= 4
    return rev[_phase_order(scale)]


def _phase_saliency_fused_wide(model: GoogLeNet, img, scale: int):
    """Wide-batch phase pass: each trunk stage runs as four full-width
    batches, one per sub-phase digit, over all maps of the previous level.
    Each stage's four outputs are written into one preallocated level
    tensor (no concatenation copy); stage-5 features go straight through
    the fc head per phase, so the level-5 set is never held at once.
    Output is phase-major; the stitch uses :func:`_phase_order_wide`."""
    h0, w0 = img.shape
    canvas = _canvas(img, scale)
    hp = canvas.shape[0] - scale
    wp = canvas.shape[1] - scale
    feats = canvas[None, None, scale:scale + hp, scale:scale + wp]
    fills = _background_constants(model, img.dtype, img.device)
    for stage in (1, 2, 3, 4):
        n = feats.shape[0]
        level = None
        for p in range(4):
            out = model(_translate_all(feats, p, fills[stage - 1]), stage=stage)
            if level is None:
                level = out.new_empty((4 * n,) + tuple(out.shape[1:]))
            level[p * n:(p + 1) * n] = out
            del out
        feats = level
    probs = []
    for p in range(4):
        f5 = model(_translate_all(feats, p, fills[4]), stage=5)
        probs.append(torch.softmax(fc_logits(model, f5), dim=-1)[..., 1])
        del f5
    probs = torch.cat(probs, dim=0)                 # (1024, h5, w5)
    order = torch.as_tensor(_phase_order_wide(scale), device=probs.device)
    return stitch_stack((h0, w0), probs[order], scale)


@torch.inference_mode()
def fcn_phase_saliency(model: GoogLeNet, img, scale: int = 32,
                       layout: str = "wide"):
    """Phase-deduplicated shift-and-stitch: exact fast path.

    Exactness: with the image embedded in a zero canvas wide enough for
    every shift, conv zero-padding equals the canvas zeros and ceil-mode
    max pooling over the post-ReLU (non-negative) features is invariant
    to trailing zero rows, so stage(translate_by_2(x)) ==
    translate_by_1(stage(x)); shift t's trunk output is the phase map
    indexed by t's binary digits. With trained BatchNorm the outputs
    within the trunk's receptive field of the flightline edges can deviate
    from the literal per-shift path (conv padding is pinned to the phase
    map's boundary instead of each shift's view); with fresh BN statistics
    the paths agree.

    Requires ``scale`` == 32 (the trunk's output stride).
    """
    if scale != 32:
        raise ValueError("phase-dedup path requires scale == 32")
    if layout != "wide":
        raise NotImplementedError(
            f"layout {layout!r} is not ported; only 'wide' "
            "(ROADMAP: modules to port, item 4)")
    return _phase_saliency_fused_wide(model, img, scale)


def load_saliency_model(weights_path: str, device="cuda") -> GoogLeNet:
    """Weights file (``.npz`` Flax layout or ``.pt``) -> the folded and
    fused float32 inference model on ``device``, in eval mode."""
    dev = resolve_device(device)
    model = GoogLeNet(num_classes=2)
    model.load_state_dict(load_weights(weights_path))
    return fold_inference(model.eval()).to(dev)


def fcn_saliency_image(img, model: GoogLeNet, model_name: str = "multi_64",
                       scale: int = 32, batch: int = 16, nodata=-9999.0,
                       method: str = "auto", device="cuda"):
    """End-to-end: raw CH4 band -> preprocessed -> saliency with nodata
    re-stamped (reference: fcn_pred_pipeline.py:219-242).

    ``img``: (H, W) numpy array or tensor. ``model``: a canonical or
    folded GoogLeNet; a canonical one is folded here. ``method``: 'shift'
    (per-shift batches, any scale), 'phase' (scale 32 only) or 'auto'
    (phase when scale == 32). Returns an (H, W) float32 tensor on
    ``device``.
    """
    dev = resolve_device(device)
    if not (model.fused and model.folded):
        model = fold_inference(model.eval())
    model = model.to(dev).eval()
    dtype = next(model.parameters()).dtype
    mean, std = norm_for_model(model_name)
    raw = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    x = preprocess_ch4(raw.to(dtype), mean, std)
    if method == "auto":
        method = "phase" if scale == 32 else "shift"
    if method == "phase" and (img.shape[0] > MAX_UNBLOCKED_LINES
                              or img.shape[0] * img.shape[1] > MAX_UNBLOCKED_PX):
        method = "phase-blocked"
    if method in ("phase-blocked", "dilated"):
        raise NotImplementedError(
            f"FCN method {method!r} is not ported yet "
            "(ROADMAP: modules to port, item 4)")
    if method == "phase":
        sal = fcn_phase_saliency(model, x, scale=scale)
    elif method == "shift":
        sal = fcn_shift_saliency(model, x, scale=scale, batch=batch)
    else:
        raise ValueError(f"unknown FCN method {method!r}")
    # stamp in f32 whatever the trunk's dtype, so every consumer's
    # == nodata filter finds the exact sentinel
    return torch.where(raw == nodata, torch.full_like(raw, nodata),
                       sal.to(torch.float32))
