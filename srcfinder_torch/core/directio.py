"""Positional file reads with an O_DIRECT path, for the ENVI readers.

The port's own copy of the JAX package's ``core/directio.py``. The
reference streams through spectral/numpy memmaps (robust_mf.py:207,
297-298; masks_sds.py:289-296) with fancy indexes. Here reads are
buffered by default: each extent, or each band run over consecutive
lines in one strided copy, is copied out of a read-only mapping of the
file (the page cache). With ``SRCFINDER_DIRECT_IO=1`` they use
``O_DIRECT`` ``preadv``, which reads file data straight into
page-aligned buffers instead of through the page cache, and falls back
to the buffered reads when O_DIRECT is unavailable (tmpfs and other
filesystems that refuse it, alignment surprises at a read).
``DirectFile.mode`` says which mode a file ended in. On an H100 host,
with the file in the page cache, the mapped copies of a flightline's
band runs measured faster than ``pread`` of the same runs, and both
faster than O_DIRECT (chip_smoke.py's "readers" line, PERF.md).

Alignment contract: O_DIRECT requires the file offset, the byte count and
the destination address all aligned to the logical block size (4096
covers the usual targets). Reads therefore cover the aligned superset
[align_down(offset), align_up(offset + nbytes)) in a page-aligned buffer,
and the caller receives a zero-copy view shifted by ``offset % 4096``
into it. Views are 4-byte aligned whenever ``offset`` is (every ENVI
sample offset of a 4-byte type is), which numpy needs to reinterpret
them as float32.
"""

from __future__ import annotations

import os

import numpy as np
from numpy.lib.stride_tricks import as_strided

__all__ = ["DirectFile", "direct_io_enabled"]

_ALIGN = 4096
_SEG = 64 << 20          # bytes per preadv call (virtio-friendly)


def direct_io_enabled() -> bool:
    """O_DIRECT only when ``SRCFINDER_DIRECT_IO=1`` (the JAX package has it
    on unless ``=0``): with the radiance in the page cache, as a pipeline
    finds the file it has just been handed, O_DIRECT reads it from the
    disk again."""
    return (os.environ.get("SRCFINDER_DIRECT_IO", "0") == "1"
            and hasattr(os, "O_DIRECT"))


def _aligned_empty(nbytes: int) -> np.ndarray:
    """Page-aligned uint8 buffer: over-allocate and slice."""
    raw = np.empty(nbytes + _ALIGN, np.uint8)
    off = (-raw.ctypes.data) % _ALIGN
    return raw[off:off + nbytes]


class DirectFile:
    """Positional reader with an O_DIRECT fast path.

    ``read_range(offset, nbytes)`` returns a uint8 array of exactly
    ``nbytes`` (with O_DIRECT a view into a fresh page-aligned buffer).
    Thread-compatible: concurrent reads are safe (``os.preadv`` is
    positional, the mapping read-only; no shared mutable state beyond the
    fd, the mapping and the one-shot fallback flag).
    """

    def __init__(self, path: str):
        self.path = path
        self.size = os.path.getsize(path)
        self.direct = False
        self.fd = -1
        self._map = None        # the file's read-only mapping, made at first use
        self._retired = []      # fds parked by _demote (see below)
        if direct_io_enabled():
            try:
                self.fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
                self.direct = True
            except OSError:
                pass  # filesystem refuses O_DIRECT: buffered fallback
        if self.fd < 0:
            self.fd = os.open(path, os.O_RDONLY)

    @property
    def mode(self) -> str:
        """"O_DIRECT" or "buffered": the mode the file is in now (a failed
        O_DIRECT read demotes it for good)."""
        return "O_DIRECT" if self.direct else "buffered"

    # -- lifecycle ----------------------------------------------------
    def close(self, _close=os.close):
        # _close bound at def time: os.close may already be torn down
        # when __del__ runs at interpreter shutdown
        self._map = None
        if self.fd >= 0:
            _close(self.fd)
            self.fd = -1
        while self._retired:
            _close(self._retired.pop())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- reads --------------------------------------------------------
    def _pread_full(self, mv: memoryview, offset: int) -> int:
        """Fill ``mv`` from ``offset`` in <= _SEG chunks; returns bytes
        read (short only at EOF)."""
        total = 0
        n = len(mv)
        while total < n:
            want = min(_SEG, n - total)
            got = os.preadv(self.fd, [mv[total:total + want]],
                            offset + total)
            if got <= 0:
                break
            total += got
        return total

    def _mapped(self) -> np.ndarray:
        """The whole file as a read-only uint8 memmap, the buffered reads'
        source."""
        if self._map is None:
            self._map = np.memmap(self.path, np.uint8, mode="r", shape=(self.size,))
        return self._map

    def _copy_strided(self, offsets, nbytes: int, out) -> np.ndarray:
        """Buffered gather into ``out``: the extents copied out of the
        mapping, in one strided copy when they are evenly spaced (a band
        run over consecutive lines), else one copy each."""
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

    def _demote(self):
        """Reopen buffered after a runtime O_DIRECT failure. The old fd
        is PARKED, not closed: a concurrent read_range may be mid-preadv
        on it, and closing would hand its number to an unrelated open
        (silent wrong-file reads). One parked fd per demotion, closed in
        close() — bounded and harmless."""
        fd = os.open(self.path, os.O_RDONLY)
        self._retired.append(self.fd)
        self.fd = fd
        self.direct = False

    def read_range(self, offset: int, nbytes: int) -> np.ndarray:
        """Exactly ``nbytes`` from ``offset`` as uint8 (zero-filled past
        EOF, mirroring memmap-of-truncated-file semantics is NOT
        attempted: short files raise)."""
        if offset < 0 or offset + nbytes > self.size:
            raise ValueError(
                f"read [{offset}, {offset + nbytes}) outside "
                f"{self.path} (size {self.size})")
        if nbytes == 0:
            return np.empty(0, np.uint8)
        if self.direct:
            head = offset % _ALIGN
            off0 = offset - head
            span = head + nbytes
            span_al = -(-span // _ALIGN) * _ALIGN
            buf = _aligned_empty(span_al)
            try:
                got = self._pread_full(memoryview(buf), off0)
            except OSError:
                self._demote()
            else:
                if got >= span:
                    return buf[head:head + nbytes]
                if off0 + got >= offset + nbytes:  # EOF-truncated tail
                    return buf[head:head + nbytes]
                self._demote()  # unexpected short read: play it safe
        return np.array(self._mapped()[offset:offset + nbytes])

    def read_strided(self, offsets, nbytes: int, out=None) -> np.ndarray:
        """Gather equally-sized extents: returns (len(offsets), nbytes)
        uint8. The per-line band-window read pattern of the CMF
        (robust_mf.py:297-298 reads [:, b0:b1, :] of a BIL cube — one
        contiguous extent per line).

        Extents are coalesced (consecutive offsets whose gap equals the
        extent length collapse into one contiguous read), and all O_DIRECT
        staging of short runs goes through one >= 4 MB bounce buffer per
        call instead of a fresh buffer per extent.

        Buffered, the extents are copied out of the file's mapping
        (:meth:`_copy_strided`).

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
        if not self.direct:
            return self._copy_strided(offsets, nbytes, out)
        bounce = None
        i = 0
        while i < len(offsets):
            j = i + 1
            while (j < len(offsets)
                   and offsets[j] == offsets[j - 1] + nbytes):
                j += 1
            off, span = offsets[i], (j - i) * nbytes
            if off < 0 or off + span > self.size:
                raise ValueError(
                    f"read [{off}, {off + span}) outside {self.path} "
                    f"(size {self.size})")
            if span >= (4 << 20):
                # big contiguous run: a buffer of its own
                out[i:j] = self.read_range(off, span).reshape(j - i,
                                                              nbytes)
            else:
                head = off % _ALIGN
                span_al = -(-(head + span) // _ALIGN) * _ALIGN
                if bounce is None or bounce.size < span_al:
                    bounce = _aligned_empty(max(span_al, 4 << 20))
                try:
                    got = self._pread_full(
                        memoryview(bounce)[:span_al], off - head)
                except OSError:
                    got = -1
                if got < 0 or off - head + got < off + span:
                    self._demote()      # the rest buffered
                    self._copy_strided(offsets[i:], nbytes, out[i:])
                    return out
                out[i:j] = bounce[head:head + span].reshape(j - i,
                                                            nbytes)
            i = j
        return out
