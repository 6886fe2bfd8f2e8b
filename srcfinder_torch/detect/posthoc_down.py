"""Gaussian-PSF downsampling of a flightline to coarser GSD.

Port of the JAX package's ``detect/posthoc_down.py``. Reference
(cnn/posthoc_down.py): blur with a gaussian kernel whose FWHM equals the
target resolution via astropy ``convolve_fft`` (nan_treatment='fill', fill
0, preserve_nan) then nearest-resample with ``gdal_translate -tr``. Here
the FFT convolution is ``torch.fft`` on the device, in f32 as the JAX
package's, and the resample is a gather of the rows and columns that hold
each target cell's centre; no GDAL subprocesses.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["gkern", "get_pixsig", "gaussian_downsample"]


def gkern(l: int = 5, sig: float = 1.0, device="cpu"):
    """Normalized 2-D gaussian kernel, f32 (reference: posthoc_down.py:13-19)."""
    ax = torch.linspace(-(l - 1) / 2.0, (l - 1) / 2.0, l, device=device)
    sig = torch.tensor(sig, dtype=torch.float32, device=device)
    gauss = torch.exp(-0.5 * ax.square() / sig.square())
    kernel = torch.outer(gauss, gauss)
    return kernel / kernel.sum()


def get_pixsig(ores: float, tres: float) -> float:
    """PSF sigma in pixels from source/target resolution: the target GSD
    is the blur FWHM (reference: posthoc_down.py:21-25)."""
    sig = tres / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    return sig / ores


def _nan_preserving_fft_blur(data, sig, kerw: int):
    """FFT convolution with NaN->0 fill and NaN restoration
    (astropy convolve_fft nan_treatment='fill', preserve_nan=True,
    boundary='fill' 0 — reference: posthoc_down.py:84-92)."""
    nanmask = torch.isnan(data)
    filled = torch.where(nanmask, 0.0, data)
    h, w = data.shape
    pad = kerw // 2
    big = F.pad(filled, (pad, pad, pad, pad))
    kbig = torch.zeros_like(big)
    kbig[:kerw, :kerw] = gkern(kerw, sig, data.device)
    # center the kernel so the convolution is phase-correct
    kbig = torch.roll(kbig, (-pad, -pad), dims=(0, 1))
    out = torch.fft.irfft2(torch.fft.rfft2(big) * torch.fft.rfft2(kbig),
                           s=big.shape)
    out = out[pad:pad + h, pad:pad + w]
    return torch.where(nanmask, torch.nan, out)


def gaussian_downsample(data, src_res: float, dst_res: float = 30.0,
                        nodata: float = -9999.0, device="cuda"):
    """Blur to the target PSF then nearest-resample (reference:
    posthoc_down.py:64-110). Returns the resampled f32 tensor on
    ``device``."""
    dev = resolve_device(device)
    data = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    data = torch.where(data == nodata, torch.nan, data)
    sig = get_pixsig(src_res, dst_res)
    kerw = int(np.ceil((dst_res * np.sqrt(2) * 2) / src_res))
    if kerw % 2 == 0:
        kerw += 1
    blurred = _nan_preserving_fft_blur(data, sig, kerw)
    blurred = torch.where(torch.isnan(blurred), nodata, blurred)
    # nearest resample at scale dst_res/src_res: gdal picks the pixel
    # containing each target-cell center (index arithmetic in f32, as the
    # JAX package's)
    scale = torch.tensor(dst_res / src_res, dtype=torch.float32)
    h, w = data.shape
    oh, ow = int(h / (dst_res / src_res)), int(w / (dst_res / src_res))

    def centres(n, size):
        c = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * scale)
        return torch.clamp(c, 0, size - 1).long().to(dev)

    return blurred[centres(oh, h)][:, centres(ow, w)]
