"""Positional file reads for the ENVI readers: copies out of a mapping.

The port's counterpart of the JAX package's ``core/directio.py``. The
reference streams through spectral/numpy memmaps (robust_mf.py:207,
297-298; masks_sds.py:289-296) with fancy indexes. Here each extent, or
each band run over consecutive lines in one strided copy, is copied out
of a read-only mapping of the file (the page cache). The JAX package
reads past the page cache (direct I/O) by default; the port does not
carry that path. On an H100 host, with a 12,000-line flightline in the
page cache, its band runs took 1.898 s as mapped copies, 3.728 s with
``pread`` and 5.398 s with direct I/O (PERF.md). The bytes are the same
either way.
"""

from __future__ import annotations

import os

import numpy as np
from numpy.lib.stride_tricks import as_strided

__all__ = ["DirectFile"]


class DirectFile:
    """Positional reader over the file's read-only mapping.

    ``read_range(offset, nbytes)`` returns a fresh uint8 array of exactly
    ``nbytes``; ``read_strided`` gathers equally-sized extents.
    Thread-compatible: concurrent reads are safe (the mapping is
    read-only, and no other state is shared).
    """

    def __init__(self, path: str):
        self.path = path
        self.size = os.path.getsize(path)
        self._map = None        # the file's read-only mapping, made at first use

    # -- lifecycle ----------------------------------------------------
    def close(self):
        self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- reads --------------------------------------------------------
    def _mapped(self) -> np.ndarray:
        """The whole file as a read-only uint8 memmap, the reads' source."""
        if self._map is None:
            self._map = np.memmap(self.path, np.uint8, mode="r", shape=(self.size,))
        return self._map

    def read_range(self, offset: int, nbytes: int) -> np.ndarray:
        """Exactly ``nbytes`` from ``offset`` as uint8 (short files
        raise)."""
        if offset < 0 or offset + nbytes > self.size:
            raise ValueError(
                f"read [{offset}, {offset + nbytes}) outside "
                f"{self.path} (size {self.size})")
        if nbytes == 0:
            return np.empty(0, np.uint8)
        return np.array(self._mapped()[offset:offset + nbytes])

    def read_strided(self, offsets, nbytes: int, out=None) -> np.ndarray:
        """Gather equally-sized extents: returns (len(offsets), nbytes)
        uint8. The per-line band-window read pattern of the CMF
        (robust_mf.py:297-298 reads [:, b0:b1, :] of a BIL cube — one
        contiguous extent per line).

        The extents are copied out of the mapping in one strided copy
        when they are evenly spaced (a band run over consecutive lines),
        else one copy each.

        ``out``: optional (len(offsets), nbytes) uint8 destination whose
        rows are each contiguous but may lie apart (a band run's slice of
        a line block); the reads land in it. Returned."""
        offsets = list(offsets)
        if out is None:
            out = np.empty((len(offsets), nbytes), np.uint8)
        elif (out.dtype != np.uint8 or out.shape != (len(offsets), nbytes)
              or (nbytes > 1 and out.strides[1] != 1)):
            raise ValueError(f"read_strided: out must be ({len(offsets)}, {nbytes}) "
                             f"uint8 with contiguous rows")
        if nbytes == 0 or not offsets:
            return out
        lo, hi = min(offsets), max(offsets) + nbytes
        if lo < 0 or hi > self.size:
            raise ValueError(f"read [{lo}, {hi}) outside {self.path} (size {self.size})")
        src = self._mapped()
        step = offsets[1] - offsets[0] if len(offsets) > 1 else 0
        if step >= 0 and all(b - a == step for a, b in zip(offsets, offsets[1:])):
            out[...] = as_strided(src[lo:], shape=out.shape, strides=(step, 1))
        else:
            for k, off in enumerate(offsets):
                out[k] = src[off:off + nbytes]
        return out
