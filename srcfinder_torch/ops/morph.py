"""Binary dilation by a disk or a diamond: CUDA kernel + plain version.

``dilate(seeds, radius, element)`` dilates a 2-D boolean map by
``disk(radius)`` (the x^2 + y^2 <= r^2 footprint; ``element="disk"``) or
by the taxicab ball of that radius, which ``radius`` passes of the 3 x 3
cross give (``element="diamond"``), with nothing outside the map: what
``scipy.ndimage.binary_dilation`` gives. For a tensor on the CPU it runs
the plain PyTorch version; for a CUDA tensor it launches ``csrc/morph.cu``
(built for ``sm_90a`` at first use) and raises if it cannot. The kernel
replaces no TPU kernel: the JAX package's ``masks/sds.py`` dilates on the
host with scipy.

Both elements are symmetric, convex and the same under a swap of x and
y: row k and column k are |dx| <= hw[k] and |dy| <= hw[k]
(:func:`halfwidths`). So a pixel is covered exactly when a row y' of its
column has a seed within hw[|y - y'|] along that row, that is when |y - y'|
<= hw[d], d the distance along row y' to its nearest seed. The kernel and
:func:`dilate_ref` compute that in two passes of scans: d (and e = hw[d],
-1 past the table) along the rows, then along the columns the running max
of y' + e and min of y' - e against y.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import CudaKernel

__all__ = ["dilate", "dilate_ref", "halfwidths", "launches", "ELEMENTS", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = [_P] * 4 + [_I] * 4 + [_P]
#: the kernel's entry point of each structuring element
ELEMENTS = {"disk": "srcf_dilate_disk_u8", "diamond": "srcf_dilate_diamond_u8"}
KERNEL = CudaKernel("morph.cu", dict.fromkeys(ELEMENTS.values(), _SIG))
_FAR = 1 << 30          # "no seed" index of the row pass (csrc/morph.cu kFar)


def halfwidths(element: str, radius: int) -> list:
    """[hw[k] for k in 0..radius]: row k of the element is |dx| <= hw[k],
    and so is column k with dy. Disk: isqrt(r^2 - k^2); diamond: r - k.
    Integers throughout (``math.isqrt``)."""
    if element not in ELEMENTS:
        raise ValueError(f"dilate: unknown structuring element {element!r}")
    r = int(radius)
    if r < 0:
        raise ValueError(f"dilate: radius {radius} is negative")
    return [math.isqrt(r * r - k * k) if element == "disk" else r - k for k in range(r + 1)]


def dilate_ref(seeds, table):
    """The two passes in plain PyTorch: ``seeds`` (H, W) bool or uint8,
    ``table`` the element's half-widths hw[0..]. Returns (H, W) bool."""
    H, W = seeds.shape
    s = seeds.bool()
    x = torch.arange(W, dtype=torch.int32, device=s.device).expand(H, W)
    last = torch.where(s, x, -_FAR).cummax(dim=1).values
    nxt = torch.where(s, x, _FAR).flip(1).cummin(dim=1).values.flip(1)
    d = torch.minimum(x - last, nxt - x).clamp_(max=len(table))
    e = torch.tensor(list(table) + [-1], dtype=torch.int32, device=s.device)[d.long()]
    y = torch.arange(H, dtype=torch.int32, device=s.device)[:, None]
    down = (y + e).cummax(dim=0).values >= y
    up = (y - e).flip(0).cummin(dim=0).values.flip(0) <= y
    return down | up


def dilate(seeds, radius, element: str):
    """``seeds`` (H, W) bool or uint8 dilated by ``element`` ("disk" or
    "diamond") of ``radius``: :func:`dilate_ref` on the CPU, the CUDA
    kernel on a card."""
    if seeds.dim() != 2:
        raise ValueError(f"dilate: seeds must be (H, W), got {tuple(seeds.shape)}")
    H, W = seeds.shape
    table = halfwidths(element, radius)
    if seeds.numel() == 0:
        return torch.zeros((H, W), dtype=torch.bool, device=seeds.device)
    if seeds.device.type == "cpu":
        return dilate_ref(seeds, table)
    if seeds.device.type != "cuda":
        raise ValueError(f"dilate: unsupported device {seeds.device}")
    if seeds.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"dilate: dtype {seeds.dtype} not supported")
    if not seeds.is_contiguous():
        raise ValueError("dilate: seeds must be contiguous")
    if max(H, W, table[0]) >= _FAR:
        raise ValueError(f"dilate: a {H} x {W} map or radius {table[0]} is too large")
    out = torch.empty((H, W), dtype=torch.bool, device=seeds.device)
    e = torch.empty((H, W), dtype=torch.int32, device=seeds.device)
    v = torch.tensor(table, dtype=torch.int32, device=seeds.device)
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        KERNEL.launch(ELEMENTS[element], seeds.data_ptr(), out.data_ptr(), e.data_ptr(),
                      v.data_ptr(), H, W, len(table), table[0], stream)
    return out


def launches() -> dict:
    """{element: kernel launches} since the last ``KERNEL.reset()``."""
    return {e: KERNEL.counts[fn] for e, fn in ELEMENTS.items()}
