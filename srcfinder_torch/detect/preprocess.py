"""CNN/FCN input preprocessing (reference: cnn_pred_pipeline.py:19-30
ClampCH4, :126-157 per-campaign Normalize)."""

from __future__ import annotations

import torch

from ..models.googlenet import CAMPAIGN_NORM

__all__ = ["preprocess_ch4", "norm_for_model"]


def norm_for_model(model_name: str):
    """(mean, std) for a named model (reference: cnn_pred_pipeline.py:126-157;
    'multi' models share 115/190)."""
    if model_name in CAMPAIGN_NORM:
        return CAMPAIGN_NORM[model_name]
    if "multi" in model_name:
        return (115.0, 190.0)
    raise KeyError(f"unknown model {model_name}")


def preprocess_ch4(x, mean: float, std: float, vmin: float = 0.0,
                   vmax: float = 4000.0):
    """clamp[vmin,vmax] then normalize (reference: cnn_pred_pipeline.py:
    126-133 composes ClampCH4(0,4000) + Normalize(mean,std))."""
    return (torch.clamp(x, vmin, vmax) - mean) / std
