"""CNN -> FCN head (reference: cnn/fcn_pred_pipeline.py:155-160): the fc
layer applied per position of the stride-32 trunk features is a 1x1
convolution, so the network is fully convolutional with no weight copy.

The public functions keep the JAX package's NHWC layout at their edges.
"""

from __future__ import annotations

import torch

from .googlenet import GoogLeNet

__all__ = ["fc_logits", "fcn_apply", "fcn_saliency"]


def fc_logits(model: GoogLeNet, feats):
    """Per-position fc over NCHW trunk features -> (N, h, w, classes)."""
    return (torch.einsum("nchw,kc->nhwk", feats, model.fc.weight)
            + model.fc.bias)


def fcn_apply(model: GoogLeNet, x):
    """Fully-convolutional logits at output stride 32.

    x: (N, H, W, 1) NHWC -> (N, H//32, W//32, num_classes)
    """
    feats = model(x.permute(0, 3, 1, 2), features_only=True)
    return fc_logits(model, feats)


def fcn_saliency(model: GoogLeNet, x):
    """Softmax class-1 probability map (reference:
    fcn_pred_pipeline.py:228-233)."""
    return torch.softmax(fcn_apply(model, x), dim=-1)[..., 1]
