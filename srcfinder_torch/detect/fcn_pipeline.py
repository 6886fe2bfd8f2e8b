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
  previous level; the "scan" layout steps over the parent maps in chunks.
  :func:`fcn_phase_saliency_batch` runs several same-shaped scenes
  through one scan-layout pass, and :func:`fcn_phase_saliency_blocked`
  runs a long flightline as line windows with an exact halo;
- :func:`fcn_dilated_saliency`: the same output from one dense a-trous
  trunk pass, or from halo-exact line windows of the canvas past
  :data:`DILATED_WINDOW_PX`.

The convolutions go to cuDNN through ``torch.nn.functional.conv2d``; the
phase translate and the stitch are plain tensor ops.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.convert import load_weights
from ..models.fcn import fc_logits
from ..models.googlenet import GoogLeNet, fold_inference
from .preprocess import norm_for_model, preprocess_ch4

__all__ = ["fcn_shift_saliency", "fcn_phase_saliency", "unblocked_limits",
           "fcn_phase_saliency_batch", "fcn_phase_saliency_blocked",
           "fcn_dilated_saliency", "stitch_stack", "divisibility_pad",
           "saliency_model", "load_saliency_model", "fcn_saliency_image"]

#: Line and pixel counts above which ``fcn_saliency_image`` reroutes the
#: phase path through the halo-blocked variant (overridable with the
#: environment variables SRCFINDER_FCN_MAX_LINES / SRCFINDER_FCN_MAX_PX),
#: and the pixel budget of one blocked window. The JAX package's values:
#: they decide which path a scene takes, and off the 32-line grid the
#: blocked path's bottom halo rows differ, so the port chooses alike.
MAX_UNBLOCKED_LINES = 7680
MAX_UNBLOCKED_PX = 5_000_000
WINDOW_BUDGET_PX = 3_500_000

#: Halo (input lines) for exact blocked evaluation: the trunk's receptive
#: field (conv1 7, pool1 11, conv3 19, pool2 27, inception3a/b +2*8 each
#: = 59, pool3 75, inception4a-e +2*16 each = 235, pool4 251, inception5a/b
#: +2*32 each = 379) plus one 32-pixel shift-grid offset on each side,
#: rounded up to the 32-line phase grid.
TRUNK_HALO = 448

#: Pixel budget of one canvas pass of the dilated path (a canvas is the
#: scene padded to the 32-line grid plus ``scale`` on each side): the dense
#: pass holds full-resolution maps of up to 832 channels, ~25 KB per canvas
#: pixel in f32 (48.35 GB at 2801 x 598, a 2880 x 672 canvas, on an H100
#: 80GB; 62.29 GB and full speed at 3,647 lines, 2.49 M pixels). Past ~2.5
#: M pixels the pass still fits but runs ~13x slower, as the card runs short
#: of convolution workspace. A larger canvas runs as line windows of at most
#: this many pixels (:func:`fcn_dilated_saliency`).
DILATED_WINDOW_PX = 2_500_000

#: Parent maps per step of the scan layout at stages 1, 2, 3 and 4+5.
SCAN_CHUNKS = (2, 4, 8, 1)

#: Level-3 maps per step of each shard's stages 4+5 under a mesh: a
#: shard's working set is then that of 4 maps, whatever its share, so
#: shards that share a card fit together (four shards of a 2801 x 598
#: band peaked at 55.6 GB on one H100 with each shard's 16 maps at once).
MESH_CHUNK45 = 4


def unblocked_limits():
    """(max lines, max pixels) past which the phase path runs blocked:
    :data:`MAX_UNBLOCKED_LINES` and :data:`MAX_UNBLOCKED_PX`, or the
    environment's SRCFINDER_FCN_MAX_LINES and SRCFINDER_FCN_MAX_PX."""
    return (int(os.environ.get("SRCFINDER_FCN_MAX_LINES", MAX_UNBLOCKED_LINES)),
            int(os.environ.get("SRCFINDER_FCN_MAX_PX", MAX_UNBLOCKED_PX)))


def _auto_block(width: int, scale: int) -> int:
    """Largest block (a multiple of ``scale``) whose window
    ``(block + 2*TRUNK_HALO) * width`` stays within
    :data:`WINDOW_BUDGET_PX`; at least one ``scale`` row group for extreme
    widths."""
    block = (WINDOW_BUDGET_PX // max(width, 1)) - 2 * TRUNK_HALO
    return max(scale, (block // scale) * scale)


def divisibility_pad(img, scale: int):
    """Pad bottom/right of (..., H, W) so H and W are divisible by
    ``scale``. Reproduces the reference quirk of adding a FULL extra
    ``scale`` when already divisible (fcn_pred_pipeline.py:47-51 pads
    ``scale - dim % scale``)."""
    h, w = img.shape[-2:]
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
    canvas = _canvas(img, scale)
    nshift = scale * scale
    outs = [_shift_probs(model, canvas, scale, range(i, min(i + batch, nshift)))
            for i in range(0, nshift, batch)]
    return stitch_stack(tuple(img.shape), torch.cat(outs, dim=0), scale)


def _shift_probs(model: GoogLeNet, canvas, scale: int, shifts):
    """Class-1 probability maps (len(shifts), h, w) of the shift views
    ``shifts`` (indices top*scale + left) of ``canvas``, as one batch."""
    hp = canvas.shape[0] - scale
    wp = canvas.shape[1] - scale
    views = torch.stack([canvas[scale - t: scale - t + hp, scale - l: scale - l + wp]
                         for t, l in (divmod(k, scale) for k in shifts)])
    feats = model(views[:, None], features_only=True)
    return torch.softmax(fc_logits(model, feats), dim=-1)[..., 1]


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


def _stage_all_phases(model: GoogLeNet, feats, fill, stage: int, chunk: int):
    """Trunk stage ``stage`` on all 4 sub-phases of every map of ``feats``
    (N, C, h, w) -> (4N, C', h', w'), stepping over ``chunk`` parent maps
    at a time; output index = parent*4 + (dt*2 + dl)."""
    out = None
    n = feats.shape[0]
    for i in range(0, n, chunk):
        f = feats[i:i + chunk]
        fin = torch.stack([_translate_all(f, p, fill) for p in range(4)], dim=1)
        o = model(fin.flatten(0, 1), stage=stage)
        if out is None:
            out = o.new_empty((4 * n,) + tuple(o.shape[1:]))
        out[4 * i:4 * i + o.shape[0]] = o
    return out


def _stage45_probs(model: GoogLeNet, feats3, fill4, fill5, chunk: int):
    """Stages 4 and 5 and the fc head, ``chunk`` level-3 maps at a time:
    each map's 4 stage-4 phases as one batch, then their 16 stage-5
    phases as one batch, so the level-4 set is never held whole.
    Returns (16N, h5, w5) probabilities, parent-major."""
    probs = []
    for i in range(0, feats3.shape[0], chunk):
        f4 = _stage_all_phases(model, feats3[i:i + chunk], fill4, 4, chunk)
        f5 = _stage_all_phases(model, f4, fill5, 5, f4.shape[0])
        del f4
        probs.append(torch.softmax(fc_logits(model, f5), dim=-1)[..., 1])
        del f5
    return torch.cat(probs, dim=0)


def _phase_probs_scan(model: GoogLeNet, canvas, scale: int, chunks):
    """Scan-layout phase pass over (S, H', W') canvases: (S, 1024, h5, w5)
    probabilities per scene in shift order. The layout is parent-major,
    so each scene's phase maps stay contiguous."""
    S = canvas.shape[0]
    hp = canvas.shape[1] - scale
    wp = canvas.shape[2] - scale
    feats = canvas[:, None, scale:scale + hp, scale:scale + wp]
    fills = _background_constants(model, canvas.dtype, canvas.device)
    for stage, chunk in zip((1, 2, 3), chunks[:3]):
        feats = _stage_all_phases(model, feats, fills[stage - 1], stage, chunk)
    probs = _stage45_probs(model, feats, fills[3], fills[4], chunks[3])
    del feats
    order = torch.as_tensor(_phase_order(scale), device=probs.device)
    return probs.reshape((S, scale * scale) + tuple(probs.shape[1:]))[:, order]


def _phase_saliency_mesh(model: GoogLeNet, img, scale: int, mesh):
    """The phase pass with its phase batch split over ``mesh``: the JAX
    package's mesh branch, stage by stage (stages 1-3 through
    :func:`_stage_all_phases`, then :func:`_stage45_probs`), each stage's
    leading ``4^level`` maps cut into contiguous shards once the shard
    count divides them and run whole on the first device until then (the
    JAX package replicates them); each shard steps over its level-3 maps
    :data:`MESH_CHUNK45` at a time at stages 4+5. One model replica and
    one set of background constants per device; the stitch runs on
    ``img``'s device."""
    from ..parallel.mesh import as_mesh, gather, replicate, run_shards

    mesh = as_mesh(mesh)
    n = len(mesh)
    models = replicate(model, mesh)
    fills = replicate(lambda dev: _background_constants(models[dev], img.dtype, dev), mesh)
    canvas = _canvas(img, scale)
    hp = canvas.shape[0] - scale
    wp = canvas.shape[1] - scale
    feats = canvas[None, None, scale:scale + hp, scale:scale + wp]

    def stage(run, feats):
        """``run(model, fills, maps)`` over the maps of ``feats``, sharded
        when the mesh divides them."""
        if feats.shape[0] % n:
            dev = mesh[0]
            return run(models[dev], fills[dev], feats.to(dev))
        k = feats.shape[0] // n
        return gather(run_shards(mesh, lambda i, dev: run(
            models[dev], fills[dev], feats[i * k:(i + 1) * k].to(dev))), mesh[0])

    for level in (1, 2, 3):
        feats = stage(lambda m, f, maps, s=level: _stage_all_phases(
            m, maps, f[s - 1], s, maps.shape[0]), feats)
    probs = stage(lambda m, f, maps: _stage45_probs(m, maps, f[3], f[4], MESH_CHUNK45),
                  feats).to(img.device)
    order = torch.as_tensor(_phase_order(scale), device=probs.device)
    return stitch_stack(tuple(img.shape), probs[order], scale)


@torch.inference_mode()
def fcn_phase_saliency(model: GoogLeNet, img, scale: int = 32,
                       layout: str = "wide", mesh=None):
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

    ``layout``: 'wide' (four full-width batches per stage) or 'scan'
    (:data:`SCAN_CHUNKS` parent maps per step at stages 1-3 and 4+5); the two
    evaluate the same stage applies with the same fills.

    ``mesh``: a list of devices (:mod:`srcfinder_torch.parallel`); the phase
    batch of each stage is split over it once its size divides the
    stage's maps (:func:`_phase_saliency_mesh`; ``layout`` is then unused).

    Requires ``scale`` == 32 (the trunk's output stride).
    """
    if scale != 32:
        raise ValueError("phase-dedup path requires scale == 32")
    if mesh is not None:
        return _phase_saliency_mesh(model, img, scale, mesh)
    if layout == "wide":
        return _phase_saliency_fused_wide(model, img, scale)
    if layout != "scan":
        raise ValueError(f"layout must be 'scan' or 'wide', got {layout!r}")
    probs = _phase_probs_scan(model, _canvas(img, scale)[None], scale, SCAN_CHUNKS)
    return stitch_stack(tuple(img.shape), probs[0], scale)


@torch.inference_mode()
def fcn_phase_saliency_batch(model: GoogLeNet, imgs, scale: int = 32):
    """N same-shaped scenes (N, H, W) through one scan-layout phase pass:
    every stage's batch is N times wider. Scenes of other shapes are
    padded to a common shape by the caller and cropped after. Each
    scene's output is its :func:`fcn_phase_saliency` output (the same
    stage applies in the same phase order); each step takes N times the
    single-scene scan's parent maps."""
    if scale != 32:
        raise ValueError("phase-dedup path requires scale == 32")
    if imgs.ndim != 3:
        raise ValueError(f"imgs must be (N, H, W), got {tuple(imgs.shape)}")
    n, h0, w0 = imgs.shape
    probs = _phase_probs_scan(model, _canvas(imgs, scale), scale,
                              tuple(n * c for c in SCAN_CHUNKS))
    return torch.stack([stitch_stack((h0, w0), p, scale) for p in probs])


@torch.inference_mode()
def fcn_phase_saliency_blocked(model: GoogLeNet, img, scale: int = 32,
                               block: int | None = None, mesh=None):
    """Long-flightline phase saliency: windows of ``block + 2*halo`` input
    lines (``halo`` = :data:`TRUNK_HALO`), each through the wide-layout
    :func:`fcn_phase_saliency`, keeping each window's
    central ``block`` rows; device memory stays at one window.
    ``block=None`` sizes the window to :data:`WINDOW_BUDGET_PX` for the
    scene's width (:func:`_auto_block`). A scene no longer than one
    window runs unblocked. ``mesh`` is passed on to each window.

    Exactness: every kept row is at least ``halo`` lines from any
    artificial cut, and ``halo`` covers the trunk's receptive field plus
    the shift grid (:data:`TRUNK_HALO`), so kept rows see the unblocked
    pass's input support, the true top and bottom edges included.
    Window starts are clamped to the 32-line phase grid so each row keeps
    its shift phase. Off the grid the scene is first padded to it, so the
    last window sees up to ``scale`` extra zero rows below the true
    bottom edge: with trained BatchNorm the bottom ``halo`` rows then
    carry the phase path's edge caveat.
    """
    h0, w0 = img.shape
    halo = TRUNK_HALO
    if block is None:
        block = _auto_block(w0, scale)
    if block % scale:
        raise ValueError("block must be a multiple of scale")
    win = block + 2 * halo
    if h0 <= win:
        return fcn_phase_saliency(model, img, scale, mesh=mesh)
    pad0 = (-h0) % scale
    if pad0:
        img = F.pad(img, (0, 0, 0, pad0))
    hp = h0 + pad0
    out = None
    for r0 in range(0, hp, block):
        n = min(block, hp - r0)
        s = max(0, min(r0 - halo, hp - win))
        sal = fcn_phase_saliency(model, img[s:s + win], scale, mesh=mesh)
        if out is None:
            out = sal.new_empty((hp, w0))
        out[r0:r0 + n] = sal[r0 - s:r0 - s + n]
        del sal
    return out[:h0]


def _dilated_block(rows: int, cols: int, scale: int) -> int:
    """Default block of the windowed dilated pass over a ``rows`` x
    ``cols`` canvas: the fewest windows of at most
    :data:`DILATED_WINDOW_PX` pixels, their blocks balanced and rounded up
    to the ``scale``-line grid (12,096 canvas rows at width 598: 5 blocks of
    2,432, windows of 3,328 lines, 2.24 M pixels)."""
    most = max(scale, (DILATED_WINDOW_PX // cols) // scale * scale - 2 * TRUNK_HALO)
    per = -(-rows // -(-rows // most))          # ceil(rows / fewest windows)
    return -(-per // scale) * scale


def _dilated_probs(model: GoogLeNet, canvas):
    """Class-1 probability at every pixel of ``canvas`` from one dense
    a-trous trunk pass."""
    feats = model(canvas[None, None], dilated=True)
    return torch.softmax(fc_logits(model, feats), dim=-1)[0, ..., 1]


@torch.inference_mode()
def fcn_dilated_saliency(model: GoogLeNet, img, scale: int = 32,
                         block: int | None = None):
    """The whole shift-and-stitch output from dense a-trous trunk passes
    (``model(x, dilated=True)``) over the canvas. The stitch writes shift
    (top, left) at offset scale-1-top and view ``top`` starts at canvas
    row scale-top, so stitched[q] == dense[q + 1], and after the stitch's
    centre crop the result is dense[scale//2 + 1:][:h0]. Equal to the
    per-shift path at fresh init; with trained BatchNorm its edge
    deviation is larger than the phase path's (the dilated pools pad -inf
    at the canvas extent, not per view); away from the canvas edges by
    the trunk's reach the two agree to rounding. Requires ``scale`` == 32.

    A canvas of more than :data:`DILATED_WINDOW_PX` pixels runs as windows
    of ``block + 2*halo`` canvas lines (``halo`` = :data:`TRUNK_HALO`), cut
    from the scene's one canvas on its ``scale``-line grid, each keeping
    its central ``block`` lines; the last window's start is clamped back
    so it keeps its length. ``block=None`` sizes them by
    :func:`_dilated_block`; a given ``block`` windows any canvas longer
    than one window. Every kept line lies at least ``halo`` lines from a
    cut, twice the trunk's reach, and the true top and bottom canvas edges
    fall inside the first and last windows, where the whole-canvas pass
    has them: the windowed map equals the whole-canvas map to convolution
    rounding. Device memory is one window's pass."""
    if scale != 32:
        raise ValueError("dilated path requires scale == 32")
    if block is not None and block % scale:
        raise ValueError("block must be a multiple of scale")
    h0, w0 = img.shape
    canvas = _canvas(img, scale)
    rows, cols = canvas.shape
    if block is None and rows * cols > DILATED_WINDOW_PX:
        block = _dilated_block(rows, cols, scale)
    if block is None or rows <= block + 2 * TRUNK_HALO:
        block = win = rows
    else:
        win = block + 2 * TRUNK_HALO
    off = scale // 2 + 1
    out = None
    for r0 in range(0, rows, block):
        a, b = max(r0, off), min(r0 + block, off + h0)     # kept canvas lines
        if a >= b:
            continue
        s = max(0, min(r0 - TRUNK_HALO, rows - win))
        probs = _dilated_probs(model, canvas[s:s + win])
        if out is None:
            out = probs.new_empty((h0, w0))
        out[a - off:b - off] = probs[a - s:b - s, off:off + w0]
        del probs
    return out


def saliency_model(state_dict, dtype=torch.float32, device="cuda") -> GoogLeNet:
    """Canonical state dict -> the folded and fused inference model on
    ``device``, in eval mode: folded once in float32, then cast once to
    ``dtype`` (``torch.bfloat16`` runs the whole trunk in bf16)."""
    dev = resolve_device(device)
    model = GoogLeNet(num_classes=2)
    model.load_state_dict(state_dict)
    return fold_inference(model.eval()).to(device=dev, dtype=dtype)


def load_saliency_model(weights_path: str, dtype=torch.float32,
                        device="cuda") -> GoogLeNet:
    """Weights file (``.npz`` Flax layout or ``.pt``) -> :func:`saliency_model`."""
    return saliency_model(load_weights(weights_path), dtype, device)


def fcn_saliency_image(img, model: GoogLeNet, model_name: str = "multi_64",
                       scale: int = 32, batch: int = 16, nodata=-9999.0,
                       method: str = "auto", device="cuda"):
    """End-to-end: raw CH4 band -> preprocessed -> saliency with nodata
    re-stamped (reference: fcn_pred_pipeline.py:219-242).

    ``img``: (H, W) numpy array or tensor. ``model``: a canonical or
    folded GoogLeNet; a canonical one is folded here. The trunk runs in
    the model's dtype. ``method``: 'shift' (per-shift batches, any
    scale), 'phase', 'phase-blocked' (line windows with an exact halo),
    'dilated' (dense a-trous passes), or 'auto' (phase when scale == 32).
    'auto' and 'phase' take the blocked path past
    :func:`unblocked_limits`, 'dilated' its line windows past
    :data:`DILATED_WINDOW_PX`. Returns an (H, W) float32 tensor on
    ``device``.
    """
    if method == "auto":
        method = "phase" if scale == 32 else "shift"
    max_lines, max_px = unblocked_limits()
    h0, w0 = img.shape
    if method == "phase" and (h0 > max_lines or h0 * w0 > max_px):
        method = "phase-blocked"
    dev = resolve_device(device)
    if not (model.fused and model.folded):
        model = fold_inference(model.eval())
    model = model.to(dev).eval()
    dtype = next(model.parameters()).dtype
    mean, std = norm_for_model(model_name)
    raw = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    x = preprocess_ch4(raw.to(dtype), mean, std)
    if method == "phase":
        sal = fcn_phase_saliency(model, x, scale=scale)
    elif method == "phase-blocked":
        sal = fcn_phase_saliency_blocked(model, x, scale=scale)
    elif method == "dilated":
        sal = fcn_dilated_saliency(model, x, scale=scale)
    elif method == "shift":
        sal = fcn_shift_saliency(model, x, scale=scale, batch=batch)
    else:
        raise ValueError(f"unknown FCN method {method!r}")
    # stamp in f32 whatever the trunk's dtype, so every consumer's
    # == nodata filter finds the exact sentinel
    return torch.where(raw == nodata, torch.full_like(raw, nodata),
                       sal.to(torch.float32))
