"""Masked moments of the CMF background model: CUDA kernel + plain version.

``masked_moments(x, m)`` returns the per-column valid count, mean and
ddof=1 covariance (see :func:`masked_moments_ref` for the definition).
For a tensor on the CPU it runs the plain PyTorch version; for a CUDA
tensor it launches ``csrc/moments.cu`` (built for ``sm_90a`` at first
use) and raises if it cannot. The kernel replaces the TPU Pallas kernel
the JAX package's ``ops/moments.py::masked_moments_pallas``; the plain
version is the JAX package's ``cmf/matched_filter.py::masked_moments``.

The kernel splits each column's lines over several blocks: :func:`plan`
chooses the split from the shapes alone, and the wrapper allocates the
per-split scratch that the kernel's fixed-order combine reads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import CudaKernel

__all__ = ["masked_moments", "masked_moments_ref", "plan", "MomentsPlan", "KERNEL"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = ([_P] * 8 + [_I, _I, _I, _I64, _I64, _I64, _I64]
        + [_I] * 8 + [_P])
KERNEL = CudaKernel("moments.cu", {"srcf_moments_f32": _SIG,
                                   "srcf_moments_f64": _SIG})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# csrc/moments.cu: ring stages, line groups per register tile, most 8 x 8
# tiles of the triangle per block; blocks the grid should reach (two per
# SM of an H100) and the shared memory a block may use
STAGES, GROUPS, MAX_TILES = 3, 4, 45
MIN_BLOCKS = 264
SMEM_MAX = 232_448
# two blocks per SM: half of an SM's 228 KB, less the 1 KB it keeps per block
SMEM_TWO_PER_SM = 233_472 // 2 - 1024


class MomentsPlan(NamedTuple):
    splits: int        # blocks along the lines of one column
    lines: int         # lines per split (a multiple of tl); the last is short
    tl: int            # lines per ring stage
    kstride: int       # shared row stride of a staged line (elements)
    tpb: int           # 8 x 8 tiles of the triangle per block
    tgroups: int       # blocks along the triangle of one column
    threads: int       # threads of the scatter kernel
    smem: int          # dynamic shared memory of the scatter kernel (bytes)
    psum: tuple        # scratch shapes: partial sums, counts, triangles
    pcnt: tuple
    ptri: tuple


@functools.lru_cache(maxsize=64)
def plan(L, C, B, dtype) -> MomentsPlan:
    """Launch plan of the kernel for an (L, C, B) cube: a pure function of
    the shapes and the element type. Lines are split so the grid has at
    least MIN_BLOCKS blocks where the lines allow it."""
    size = dtype.itemsize
    nb8 = -(-B // 8)
    b8 = nb8 * 8
    ntri = nb8 * (nb8 + 1) // 2
    tpb = min(MAX_TILES, ntri)
    tgroups = -(-ntri // tpb)
    red = GROUPS * tpb * 64 * size
    # a staged line: b8 bands with a 16-byte gap after every 128 bytes
    kstride = b8 + (16 // size) * (b8 // (128 // size))
    # the longest line tile that leaves room for two blocks per SM, else
    # the longest that fits
    fits = []
    for tl in (64, 32, 16, 8):
        # mu, the staged tiles' mask values, then the staged tiles (the
        # group sums reuse their room at the end)
        smem = (b8 + STAGES * tl) * size + max(STAGES * tl * kstride * size, red)
        if smem <= SMEM_MAX:
            fits.append((smem <= SMEM_TWO_PER_SM, tl, smem))
    if not fits:
        raise ValueError(f"masked_moments: {B} bands do not fit in shared memory")
    _, tl, smem = max(fits)
    ntile = -(-L // tl)
    want = -(-MIN_BLOCKS // (C * tgroups))
    lines = max(1, ntile // want) * tl
    splits = max(1, -(-L // lines))
    return MomentsPlan(splits, lines, tl, kstride, tpb, tgroups, tpb * GROUPS, smem,
                       (splits, C, B), (splits, C), (splits, C, B * (B + 1) // 2))


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
    p = plan(L, C, B, x.dtype)
    # 16-byte vectors of x: aligned rows of whole vectors
    vw = 16 // x.element_size()
    vec = int(x.data_ptr() % 16 == 0 and B % vw == 0
              and x.stride(0) % vw == 0 and x.stride(1) % vw == 0)
    n = torch.empty(C, dtype=x.dtype, device=x.device)
    mu = torch.empty(C, B, dtype=x.dtype, device=x.device)
    S = torch.empty(C, B, B, dtype=x.dtype, device=x.device)
    psum, pcnt, ptri = (torch.empty(shape, dtype=x.dtype, device=x.device)
                        for shape in (p.psum, p.pcnt, p.ptri))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(f"srcf_moments_{_SUFFIX[x.dtype]}",
                      x.data_ptr(), m.data_ptr(), n.data_ptr(), mu.data_ptr(),
                      S.data_ptr(), psum.data_ptr(), pcnt.data_ptr(),
                      ptri.data_ptr(), L, C, B, x.stride(0), x.stride(1),
                      m.stride(0), m.stride(1), p.splits, p.lines, p.tl,
                      p.kstride, p.tpb, p.tgroups, vec, p.smem, stream)
    return n, mu, S
