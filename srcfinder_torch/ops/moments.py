"""Masked moments of the CMF background model: CUDA kernel + plain version.

``masked_moments(x, m)`` returns the per-column valid count, mean and
ddof=1 covariance (see :func:`masked_moments_ref` for the definition).
For a tensor on the CPU it runs the plain PyTorch version; for a CUDA
tensor it launches ``csrc/moments.cu`` (built for ``sm_90a`` at first
use) and raises if it cannot. The kernel replaces the TPU Pallas kernel
the JAX package's ``ops/moments.py::masked_moments_pallas``; the plain
version is the JAX package's ``cmf/matched_filter.py::masked_moments``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

__all__ = ["masked_moments", "masked_moments_ref", "KERNEL"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = [_P, _P, _P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _I64, _P]
KERNEL = CudaKernel("moments.cu", {"srcf_moments_f32": _SIG,
                                   "srcf_moments_f64": _SIG})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def masked_moments_ref(x, m):
    """Mask-weighted mean and ddof=1 covariance per column, in the
    two-pass centered form.

    x: (L, C, B), m: (L, C) in {0, 1}
    returns n: (C,), mu: (C, B), S: (C, B, B)
    """
    m = m.to(x.dtype)
    n = m.sum(dim=0)
    mu = torch.einsum("lc,lcb->cb", m, x) / torch.clamp(n, min=1.0)[:, None]
    xc = (x - mu[None, :, :]) * m[:, :, None]
    S = (torch.einsum("lcb,lcd->cbd", xc, xc)
         / torch.clamp(n - 1.0, min=1.0)[:, None, None])
    return n, mu, S


def masked_moments(x, m):
    """:func:`masked_moments_ref` on the CPU, the CUDA kernel on a card."""
    if x.device.type == "cpu":
        return masked_moments_ref(x, m)
    if x.device.type != "cuda":
        raise ValueError(f"masked_moments: unsupported device {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"masked_moments: dtype {x.dtype} not supported")
    if x.dim() != 3:
        raise ValueError(f"masked_moments: x must be (L, C, B), got {tuple(x.shape)}")
    L, C, B = x.shape
    m = m.to(x.dtype)
    if tuple(m.shape) != (L, C) or m.device != x.device:
        raise ValueError("masked_moments: m must be (L, C) on x's device")
    if x.stride(2) != 1:
        x = x.contiguous()
    n = torch.empty(C, dtype=x.dtype, device=x.device)
    mu = torch.empty(C, B, dtype=x.dtype, device=x.device)
    S = torch.empty(C, B, B, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(f"srcf_moments_{_SUFFIX[x.dtype]}",
                      x.data_ptr(), m.data_ptr(), n.data_ptr(), mu.data_ptr(),
                      S.data_ptr(), L, C, B, x.stride(0), x.stride(1),
                      m.stride(0), m.stride(1), stream)
    return n, mu, S
