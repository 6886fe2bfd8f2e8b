"""Plume label taxonomy and codecs (reference: srcfinder_util.py:90-126
constants, :1538-1591 ``rgb2labimg``/``labimg2rgb``/``loadlabimg``,
:276-325 ``float2rgba``/``rgba2float``). The port's copy of the JAX
package's ``core/labels.py``."""

from __future__ import annotations

import numpy as np

__all__ = [
    "CMFBG", "POINTSRC", "DIFFSRC", "FALSESRC", "LOCSRC", "CMFLABELS",
    "POSRGB", "NEGRGB", "BGRGB", "LOCRGB",
    "LIDCOL", "CIDCOL", "LATCOL", "LONCOL", "LABCOL", "XLSCOL", "EVALCOL",
    "LABIMG_SUFFIX",
    "rgb2labimg", "labimg2rgb", "loadlabimg", "float2rgba", "rgba2float",
]

# class labels (reference: srcfinder_util.py:90-102)
CMFBG = 0
POINTSRC = 1
DIFFSRC = 2
FALSESRC = 3
LOCSRC = 4  # pixel location of source

CMFLABELS = [CMFBG, POINTSRC, DIFFSRC, FALSESRC]

POSRGB = (255, 0, 0)
NEGRGB = (0, 255, 255)
BGRGB = (255, 255, 0)
LOCRGB = (255, 255, 255)

# canonical plume-list columns (reference: srcfinder_util.py:119-124)
LIDCOL, CIDCOL = "Line name", "Candidate ID"
LATCOL, LONCOL = "Plume Latitude (deg)", "Plume Longitude (deg)"
LABCOL, XLSCOL = "Class label", "XLS file"
EVALCOL = "True_pos/false_pos"

LABIMG_SUFFIX = "_mask.png"


def rgb2labimg(rgbimg: np.ndarray) -> np.ndarray:
    """RGB label mask -> class-id image (reference: srcfinder_util.py:1538-1554).

    red=[255,0,0] -> POINTSRC, blue=[0,0,255] -> DIFFSRC,
    cyan=[0,255,255] -> FALSESRC, white -> LOCSRC.
    """
    assert rgbimg.shape[2] == 3
    labimg = np.zeros(rgbimg.shape[:2], dtype=np.uint8)
    rgbsum = rgbimg.sum(axis=2).astype(np.int64)
    posmask = rgbsum == 255
    labimg[posmask & (rgbimg[:, :, 0] == 255)] = POINTSRC
    labimg[posmask & (rgbimg[:, :, 2] == 255)] = DIFFSRC
    labimg[~posmask & (rgbimg[:, :, 1:] == 255).all(axis=2)] = FALSESRC
    labimg[rgbsum == 3 * 255] = LOCSRC
    return labimg


def labimg2rgb(labimg: np.ndarray, rgba: bool = False) -> np.ndarray:
    """Inverse of :func:`rgb2labimg` (reference: srcfinder_util.py:1556-1568)."""
    rows, cols = labimg.shape[:2]
    rgbimg = np.zeros([rows, cols, 3], dtype=np.uint8)
    rgbimg[labimg == POINTSRC, 0] = 255
    rgbimg[labimg == DIFFSRC, 2] = 255
    rgbimg[labimg == FALSESRC, 1:] = 255
    if rgba:
        islab = np.isin(labimg, (POINTSRC, DIFFSRC, FALSESRC))
        rgbimg = np.dstack([rgbimg, np.uint8(255) * islab.astype(np.uint8)])
    return rgbimg


def loadlabimg(labf: str) -> np.ndarray:
    """Load a label mask from .png (via PIL) or an ENVI class map
    (reference: srcfinder_util.py:1571-1591)."""
    import os
    base, ext = os.path.splitext(os.path.basename(labf))
    if ext == ".png":
        from PIL import Image
        labimg = np.asarray(Image.open(labf))
        if labimg.ndim == 3 and labimg.shape[2] in (3, 4):
            labimg = rgb2labimg(labimg[:, :, :3]).squeeze()
    elif ext == "" and base.endswith("class"):
        from .envi import open_envi
        labimg = open_envi(labf).load().squeeze()
    else:
        raise ValueError(f"Unrecognized format {labf}")
    labimg = np.uint8(labimg)
    assert np.isin(np.unique(labimg), CMFLABELS).all()
    return labimg


def float2rgba(img: np.ndarray, vmin: float = 0.0, vmax: float = 1.0,
               alpha: int = 0) -> np.ndarray:
    """Pack a [0,1] float image into the 24-bit RGB range of an RGBA uint8
    image (reference: srcfinder_util.py:276-311, cmap='binary' path)."""
    assert (img.min() >= vmin) & (img.max() <= vmax)
    rgbavec = np.uint32(((2 ** 24) - 1) * img).view(dtype=np.uint8)
    rgba = rgbavec.reshape([img.shape[0], img.shape[1], 4])
    rgba = rgba.copy()
    rgba[..., -1] = np.uint8(alpha)
    return rgba


def rgba2float(img: np.ndarray, alpha: int = 0) -> np.ndarray:
    """Inverse of :func:`float2rgba` (reference: srcfinder_util.py:313-325)."""
    imgc = np.ascontiguousarray(img).copy()
    imgc[..., -1] = np.uint8(alpha)
    out = imgc.view(np.uint32) / np.float32((2 ** 24) - 1)
    return out.squeeze()
