"""GoogLeNet / Inception-v1 with 1 input channel, as a PyTorch module.

Port of the JAX package's ``models/googlenet.py`` (reference:
cnn/archs/googlenet1.py): conv1 takes 1 channel, BasicConv2d =
conv(bias=False) + BN(eps=0.001) + ReLU, inception branch3 uses
kernel_size=3 (the torchvision 5x5 "known bug" kept for weight
compatibility), trunc-normal(std=0.01, a=-2, b=2) init, ceil-mode max
pools padded with -inf. Layout is NCHW; parameter names are the
reference's torch names (``inception3a.branch2.1.conv.weight``), so its
``state_dict`` is the reference checkpoint layout.

This is the inference network: no aux heads, no dropout.
``forward(x, dilated=True)`` runs the trunk a-trous (every stride-2 op at
stride 1, later kernels dilated by the stride removed so far), which gives
the dense full-resolution stride-32 feature field in one pass. Two
inference transforms mirror the JAX package's: ``fused=True`` runs each
inception block's three parallel 1x1 convs as one wide conv named
``fused0``, and ``folded=True`` folds each BatchNorm into its conv's
weight and bias (:func:`fold_inference`).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["GoogLeNet", "CAMPAIGN_NORM", "fuse_state_dict",
           "fold_state_dict", "fold_inference"]

#: per-campaign normalization constants
#: (reference: cnn/cnn_pred_pipeline.py:126-157)
CAMPAIGN_NORM = {
    "COVID_QC": (110.6390, 183.9152),
    "CalCH4_v8": (140.6399, 237.5434),
    "Permian_QC": (100.2635, 158.7060),
    "multi_256": (115.0, 190.0),
    "multi_64": (115.0, 190.0),
}

BN_EPS = 1e-3


def _ceil_maxpool(x, window: int, stride: int):
    """MaxPool2d(window, stride, ceil_mode=True) in NCHW: pad the
    bottom/right with -inf so the last window may start inside the input,
    then pool without padding."""
    h, w = x.shape[2], x.shape[3]
    out_h = -(-(h - window) // stride) + 1
    out_w = -(-(w - window) // stride) + 1
    pad_h = max(0, (out_h - 1) * stride + window - h)
    pad_w = max(0, (out_w - 1) * stride + window - w)
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=-float("inf"))
    return F.max_pool2d(x, window, stride)


def _dilated_maxpool(x, window: int, d: int, symmetric: bool = False):
    """Stride-1 max pool with window dilation ``d`` in NCHW: the a-trous
    form of the trunk's stride-2 ceil-mode pools (end-anchored: padded
    with -inf after the input only) and, ``symmetric=True``, of the
    inception pool branch (half the padding on each side).
    ``F.max_pool2d``'s own padding is symmetric and at most half the
    window, so the -inf padding is explicit."""
    pad = (window - 1) * d
    lo, hi = (pad // 2, pad - pad // 2) if symmetric else (0, pad)
    x = F.pad(x, (lo, hi, lo, hi), value=-float("inf"))
    return F.max_pool2d(x, window, stride=1, dilation=d)


class BasicConv2d(nn.Module):
    """conv(bias=False) + BatchNorm(eps=1e-3) + ReLU, or, folded,
    conv(bias) + ReLU (reference: googlenet1.py:266-275)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, folded: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              bias=folded)
        self.bn = None if folded else nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x, dilation: int = 1, stride_one: bool = False):
        """``dilation`` dilates the kernel (and scales its padding);
        ``stride_one`` runs a strided conv at stride 1: the a-trous trunk."""
        c = self.conv
        x = F.conv2d(x, c.weight, c.bias, 1 if stride_one else c.stride,
                     c.padding[0] * dilation, dilation)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class Inception(nn.Module):
    """Four-branch inception block (reference: googlenet1.py:184-228).

    ``fused=True`` holds branch1, branch2.0 and branch3.0 (three 1x1 convs
    over the same input) as one conv ``fused0`` whose output channels are
    their concatenation; ``branch2.0``/``branch3.0`` become identities so
    the remaining parameter names stay those of the reference."""

    def __init__(self, cin, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5,
                 pool_proj, fused: bool = False, folded: bool = False):
        super().__init__()
        conv = partial(BasicConv2d, folded=folded)
        self.fused = fused
        self.splits = (ch1x1, ch3x3red, ch5x5red)
        if fused:
            self.fused0 = conv(cin, ch1x1 + ch3x3red + ch5x5red, 1)
            first2, first3 = nn.Identity(), nn.Identity()
        else:
            self.branch1 = conv(cin, ch1x1, 1)
            first2, first3 = conv(cin, ch3x3red, 1), conv(cin, ch5x5red, 1)
        self.branch2 = nn.Sequential(first2, conv(ch3x3red, ch3x3, 3, padding=1))
        # kernel 3 (not 5): torchvision weight-compat quirk
        self.branch3 = nn.Sequential(first3, conv(ch5x5red, ch5x5, 3, padding=1))
        self.branch4 = nn.Sequential(nn.MaxPool2d(3, stride=1, padding=1),
                                     conv(cin, pool_proj, 1))

    def forward(self, x, dilation: int = 1):
        """``dilation`` > 1: the a-trous block, 3x3 convs dilated and the
        pool branch's window dilated, padded with -inf on both sides."""
        if self.fused:
            b1, b2, b3 = torch.split(self.fused0(x), self.splits, dim=1)
        else:
            b1, b2, b3 = self.branch1(x), x, x
        b2 = self.branch2[1](self.branch2[0](b2), dilation)
        b3 = self.branch3[1](self.branch3[0](b3), dilation)
        pooled = (self.branch4[0](x) if dilation == 1
                  else _dilated_maxpool(x, 3, dilation, symmetric=True))
        b4 = self.branch4[1](pooled)
        return torch.cat([b1, b2, b3, b4], dim=1)


class GoogLeNet(nn.Module):
    """1-channel GoogLeNet (reference: googlenet1.py:27-163), NCHW.

    ``forward(x, stage=k)`` computes only stride-2 trunk stage ``k`` on
    already-computed features — the phase-deduplicated FCN path drives the
    stages one by one. Stage boundaries are the downsampling ops:
    1: conv1 | 2: maxpool1+conv2+conv3 | 3: maxpool2+inception3 |
    4: maxpool3+inception4 | 5: maxpool4+inception5.
    ``features_only=True`` returns the inception5b output; otherwise the
    global-average-pooled logits.

    ``start_stage`` (1..5) enters the forward mid-trunk: ``x`` is the
    output of stage ``start_stage - 1`` and computation runs from there
    (the resume seam for trunk stages computed elsewhere, such as the
    exact CNN's fused kernels). ``start_pooled=True`` declares that ``x``
    has also been through stage ``start_stage``'s leading ceil-mode max
    pool (stages 3..5), which is then skipped.

    ``dilated=True`` runs the trunk a-trous and returns the inception5b
    features at full resolution, (N, 1024, H, W): algebraically the 1024
    shift-and-stitch phases in one pass (apply the fc per position).

    ``model.to(torch.bfloat16)`` runs the trunk in bf16: each conv
    accumulates in f32 and rounds its output to bf16.
    """

    def __init__(self, num_classes: int = 2, fused: bool = False,
                 folded: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        conv = partial(BasicConv2d, folded=folded)
        inc = partial(Inception, fused=fused, folded=folded)
        self.fused, self.folded = fused, folded
        self.num_classes = num_classes
        self.conv1 = conv(1, 64, 7, stride=2, padding=3)
        self.conv2 = conv(64, 64, 1)
        self.conv3 = conv(64, 192, 3, padding=1)
        self.inception3a = inc(192, 64, 96, 128, 16, 32, 32)
        self.inception3b = inc(256, 128, 128, 192, 32, 96, 64)
        self.inception4a = inc(480, 192, 96, 208, 16, 48, 64)
        self.inception4b = inc(512, 160, 112, 224, 24, 64, 64)
        self.inception4c = inc(512, 128, 128, 256, 24, 64, 64)
        self.inception4d = inc(512, 112, 144, 288, 32, 64, 64)
        self.inception4e = inc(528, 256, 160, 320, 32, 128, 128)
        self.inception5a = inc(832, 256, 160, 320, 32, 128, 128)
        self.inception5b = inc(832, 384, 192, 384, 48, 128, 128)
        self.fc = nn.Linear(1024, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """trunc_normal(std=0.01, a=-2, b=2) for conv and linear weights,
        zero biases, BatchNorm identity (reference: googlenet1.py:94-100)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                nn.init.trunc_normal_(mod.weight, std=0.01, a=-2.0, b=2.0,
                                      generator=generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()

    def forward(self, x, stage: int | None = None, features_only: bool = False,
                start_stage: int = 1, start_pooled: bool = False,
                dilated: bool = False):
        if dilated:
            return self._dilated_features(x)

        def runs(k):
            return stage in (None, k) and start_stage <= k

        def lead_pool(k, window):
            return x if start_pooled and start_stage == k else _ceil_maxpool(x, window, 2)

        if runs(1):
            x = self.conv1(x)
            if stage == 1:
                return x
        if runs(2):
            x = self.conv3(self.conv2(_ceil_maxpool(x, 3, 2)))
            if stage == 2:
                return x
        if runs(3):
            x = self.inception3b(self.inception3a(lead_pool(3, 3)))
            if stage == 3:
                return x
        if runs(4):
            x = lead_pool(4, 3)
            for blk in (self.inception4a, self.inception4b, self.inception4c,
                        self.inception4d, self.inception4e):
                x = blk(x)
            if stage == 4:
                return x
        if runs(5):
            x = self.inception5b(self.inception5a(lead_pool(5, 2)))
            if stage == 5:
                return x
        if features_only:
            return x
        return self.fc(x.mean(dim=(2, 3)))

    def _dilated_features(self, x):
        """The a-trous trunk: conv1 at stride 1, each stride-2 pool at
        stride 1 with its window dilated by the stride removed before it,
        and every later 3x3 conv and inception pool dilated by the stride
        removed so far (2, 4, 8, 16, 32)."""
        x = self.conv1(x, stride_one=True)
        x = _dilated_maxpool(x, 3, 2)
        x = self.conv3(self.conv2(x), 4)
        x = _dilated_maxpool(x, 3, 4)
        x = self.inception3b(self.inception3a(x, 8), 8)
        x = _dilated_maxpool(x, 3, 8)
        for blk in (self.inception4a, self.inception4b, self.inception4c,
                    self.inception4d, self.inception4e):
            x = blk(x, 16)
        x = _dilated_maxpool(x, 2, 16)
        return self.inception5b(self.inception5a(x, 32), 32)


_FUSED_BRANCHES = ("branch1", "branch2.0", "branch3.0")


def fuse_state_dict(sd):
    """Canonical state_dict -> the ``fused=True`` layout: in every
    inception block the branch1/branch2.0/branch3.0 conv and BN tensors
    are concatenated along the output-channel axis into ``fused0``.
    Per-channel math is unchanged. Pure numpy."""
    out = {}
    blocks = sorted({k.split(".")[0] for k in sd if ".branch2.0." in k})
    for k, v in sd.items():
        if not any(k.startswith(f"{b}.{br}.") for b in blocks
                   for br in _FUSED_BRANCHES):
            out[k] = v
    for b in blocks:
        for leaf in sorted({k[len(f"{b}.branch1."):] for k in sd
                            if k.startswith(f"{b}.branch1.")}):
            parts = [np.asarray(sd[f"{b}.{br}.{leaf}"]) for br in _FUSED_BRANCHES]
            out[f"{b}.fused0.{leaf}"] = (parts[0] if parts[0].ndim == 0
                                         else np.concatenate(parts, axis=0))
    return out


def fold_state_dict(sd, eps: float = BN_EPS):
    """conv(bias=False) + BN(affine, running stats) -> conv(weight', bias')
    for every BasicConv2d: weight' = weight * scale/sqrt(var+eps) per
    output channel, bias' = bias_bn - mean*scale/sqrt(var+eps), in f32;
    the BatchNorm entries disappear. Pure numpy."""
    out = {k: v for k, v in sd.items() if ".bn." not in k}
    for k in sd:
        if not k.endswith(".bn.weight"):
            continue
        p = k[:-len(".bn.weight")]
        w = np.asarray(sd[f"{p}.conv.weight"])
        inv = (np.asarray(sd[f"{p}.bn.weight"], np.float32)
               / np.sqrt(np.asarray(sd[f"{p}.bn.running_var"], np.float32) + eps))
        out[f"{p}.conv.weight"] = (np.asarray(w, np.float32)
                                   * inv[:, None, None, None]).astype(w.dtype)
        out[f"{p}.conv.bias"] = (np.asarray(sd[f"{p}.bn.bias"], np.float32)
                                 - np.asarray(sd[f"{p}.bn.running_mean"],
                                              np.float32) * inv).astype(w.dtype)
    return out


def fold_inference(model: GoogLeNet) -> GoogLeNet:
    """Canonical model -> the inference model with fused 1x1 convs and
    BatchNorm folded into the conv weights (:func:`fuse_state_dict`,
    :func:`fold_state_dict`), on the same device and dtype, in eval mode."""
    p = next(model.parameters())
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    folded = fold_state_dict(fuse_state_dict(sd))
    out = GoogLeNet(num_classes=model.num_classes, fused=True, folded=True)
    out.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in folded.items()})
    return out.to(device=p.device, dtype=p.dtype).eval()
