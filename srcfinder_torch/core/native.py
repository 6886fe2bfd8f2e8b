"""The port's host runtime: BIL window repacking, 8-connected labels and
the TIFF 6.0 LZW codec, in C++ (``ops/csrc/native.cpp``).

Port of the JAX package's ``core/native.py``, with its signatures and
results. The library is built by the host's C++ compiler into
``srcfinder_torch/_build/`` at first use (:class:`~srcfinder_torch.ops.
build.HostLibrary`) and called through ctypes, which releases the
interpreter lock for each call: threads repack, label and code at once. A
missing compiler or a failed build raises; nothing falls back to numpy.
Beside each function stands its plain version (``*_plain``), which the
tests hold it to.

Imports no torch: the tagger, host code only, reaches the codec.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.build import HostLibrary

__all__ = ["HAVE_NATIVE", "bil_window_to_lcb", "label8", "lzw_encode", "lzw_decode"]

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
LIBRARY = HostLibrary("native.cpp", {
    "srcf_bil_repack": (ctypes.c_int, [_P, ctypes.c_int] + [_I64] * 8 + [_P]),
    "srcf_label8": (_I64, [_P, _I64, _I64, _P]),
    "srcf_lzw_encode": (_I64, [_P, _I64, _P, _I64]),
    "srcf_lzw_decode": (_I64, [_P, _I64, _P, _I64]),
})

#: the source dtypes the repack reads, by the library's dtype code
REPACK_DTYPES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1, np.dtype(np.int16): 2,
                 np.dtype(np.uint16): 3, np.dtype(np.int32): 4}


def __getattr__(name):
    """``HAVE_NATIVE``: whether the library is built and loads (building
    it at the first ask), as the JAX package's flag says whether its
    extension loads."""
    if name == "HAVE_NATIVE":
        try:
            LIBRARY.load()
        except (RuntimeError, OSError):
            return False
        return True
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def bil_window_to_lcb(mm, b0: int, b1: int, c0: int, c1: int, out=None) -> np.ndarray:
    """(L, B, C) BIL source of any strides (a memmap, read-only too) ->
    float32 (L, c1-c0, b1-b0), in one cache-blocked pass. The source is
    float32, float64, int16, uint16 or int32; ``out``, if given, a
    C-contiguous float32 array of that shape."""
    src = np.asarray(mm)
    if src.ndim != 3:
        raise ValueError("the source must be 3-D (lines, bands, samples)")
    if src.dtype not in REPACK_DTYPES:
        raise TypeError(f"unsupported source dtype {src.dtype}")
    if not (0 <= b0 < b1 <= src.shape[1] and 0 <= c0 < c1 <= src.shape[2]):
        raise ValueError("window out of range")
    shape = (src.shape[0], c1 - c0, b1 - b0)
    if out is None:
        out = np.empty(shape, np.float32)
    elif (out.shape != shape or out.dtype != np.float32
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous float32 array of {shape}")
    if src.shape[0]:
        LIBRARY.call("srcf_bil_repack", src.ctypes.data, REPACK_DTYPES[src.dtype],
                     src.shape[0], *src.strides, b0, b1, c0, c1, out.ctypes.data)
    return out


def bil_window_to_lcb_plain(mm, b0, b1, c0, c1) -> np.ndarray:
    """The repack as a numpy slice, transpose and cast."""
    return np.asarray(mm)[:, b0:b1, c0:c1].transpose(0, 2, 1).astype(np.float32)


def label8(mask) -> np.ndarray:
    """8-connected component labels (int32) of ``mask`` cast to uint8
    (nonzero is foreground), ids sequential from 1 in the raster order of
    each component's first pixel: scipy's ``ndimage.label`` ids."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError("the mask must be 2-D")
    out = np.empty(mask.shape, np.int32)
    if mask.size:
        LIBRARY.call("srcf_label8", mask.ctypes.data, *mask.shape, out.ctypes.data)
    return out


def label8_plain(mask) -> np.ndarray:
    """The labels through :func:`~srcfinder_torch.core.morphology.imlabel`."""
    from .morphology import imlabel
    return imlabel(np.ascontiguousarray(mask, dtype=np.uint8)).astype(np.int32)


def lzw_encode(data) -> bytes:
    """TIFF 6.0 LZW compression (MSB first, libtiff's early width change)
    of a bytes-like object."""
    src = np.frombuffer(data, np.uint8)
    cap = src.size * 3 // 2 + src.size // 2000 + 8
    out = np.empty(cap, np.uint8)
    n = LIBRARY.call("srcf_lzw_encode", src.ctypes.data, src.size, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("LZW output exceeded its worst-case bound")
    return out[:n].tobytes()


def lzw_decode(data, size: int | None = None) -> bytes:
    """TIFF 6.0 LZW decompression of a bytes-like object, up to its EOI
    code or its end. ``size`` is the length expected (a strip's rows x
    width x bytes per pixel): the output buffer is allocated once at that
    size, and once more, at the decoded length, if the stream decodes
    longer. Raises ValueError on a code no valid stream holds."""
    src = np.frombuffer(data, np.uint8)
    cap = 4 * src.size + 64 if size is None else size
    while True:
        out = np.empty(cap, np.uint8)
        n = LIBRARY.call("srcf_lzw_decode", src.ctypes.data, src.size, out.ctypes.data, cap)
        if n < 0:
            raise ValueError(f"corrupt LZW stream (code {-1 - n})")
        if n <= cap:
            return out[:n].tobytes()
        cap = n
