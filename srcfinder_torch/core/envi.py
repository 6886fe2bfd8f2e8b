"""ENVI raster I/O with numpy memmaps.

Self-contained replacement for the spectral-python / GDAL I/O the reference
leans on (reference: srcfinder_util.py:1041-1073 ``openimg``/``openmm``/
``openimgmm``, :388-390 ``createimg``, :1341-1370 ``array2img``;
cmf/robust_mf.py:206-208, :261-263).

Supports BIL/BIP/BSQ interleaves, all standard ENVI data types, header
round-tripping and creation of writable output images. The streaming
reads (line blocks, band windows, band subsets, whole cubes, one band)
go through :class:`.directio.DirectFile`, as in the JAX package: one
contiguous extent per line, or per run of adjacent bands per line,
copied out of a read-only mapping of the file. What it does not cover
(header offsets that are not a multiple of the sample size, band subsets
of BIP and BSQ sources) reads through a numpy memmap of the raw file.
The caller moves what it reads to the device.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

__all__ = [
    "EnviImage",
    "open_envi",
    "create_envi",
    "save_envi",
    "find_header",
    "read_header",
    "write_header",
    "dtype_to_envi",
    "envi_to_dtype",
    "NODATA",
]

NODATA = -9999.0

# ENVI data type code <-> numpy dtype (little endian unless byte order=1)
_ENVI_TO_DTYPE = {
    1: "u1", 2: "i2", 3: "i4", 4: "f4", 5: "f8",
    6: "c8", 9: "c16", 12: "u2", 13: "u4", 14: "i8", 15: "u8",
}
_DTYPE_TO_ENVI = {np.dtype(v).str.lstrip("<>|="): k for k, v in _ENVI_TO_DTYPE.items()}


def dtype_to_envi(dtype) -> int:
    """numpy dtype -> ENVI data type code (reference: robust_mf.py:46-50)."""
    key = np.dtype(dtype).str.lstrip("<>|=")
    if key not in _DTYPE_TO_ENVI:
        raise ValueError(f"unsupported ENVI dtype: {dtype}")
    return _DTYPE_TO_ENVI[key]


def envi_to_dtype(code: int, byte_order: int = 0) -> np.dtype:
    order = ">" if int(byte_order) == 1 else "<"
    return np.dtype(order + _ENVI_TO_DTYPE[int(code)])


def find_header(img_file: str):
    """Locate the .hdr for an image path (reference: srcfinder_util.py:1028-1040)."""
    base, ext = os.path.splitext(img_file)
    if ext == ".hdr" and os.path.isfile(img_file):
        return img_file
    for cand in (img_file + ".hdr", base + ".hdr"):
        if os.path.isfile(cand):
            return os.path.abspath(cand)
    return None


def _find_image(hdr_file: str):
    base = hdr_file[:-4] if hdr_file.endswith(".hdr") else hdr_file
    for cand in (base, base + ".img", base + ".dat", base + ".bin"):
        if os.path.isfile(cand) and not cand.endswith(".hdr"):
            return cand
    return None


def read_header(hdr_file: str) -> "OrderedDict[str, object]":
    """Parse an ENVI header into an ordered dict.

    Values are strings, or lists of strings for ``{...}`` entries —
    matching the metadata dict convention of spectral-python that the
    reference code indexes into (e.g. ``metadata['map info'][5]``).
    """
    with open(hdr_file, "r", errors="replace") as f:
        text = f.read()
    if not text.lstrip().lower().startswith("envi"):
        raise ValueError(f"not an ENVI header: {hdr_file}")
    text = text.lstrip()[4:]

    meta: OrderedDict[str, object] = OrderedDict()
    i, n = 0, len(text)
    while i < n:
        eq = text.find("=", i)
        if eq < 0:
            break
        key = text[i:eq].strip().lower()
        j = eq + 1
        while j < n and text[j] in " \t":
            j += 1
        if j < n and text[j] == "{":
            close = text.find("}", j)
            if close < 0:
                raise ValueError(f"unterminated {{ in header {hdr_file} (key={key})")
            body = text[j + 1: close]
            if key == "description":
                meta[key] = body.strip()
            else:
                meta[key] = [s.strip() for s in body.split(",")]
            i = close + 1
        else:
            eol = text.find("\n", j)
            if eol < 0:
                eol = n
            meta[key] = text[j:eol].strip()
            i = eol + 1
        while i < n and text[i] in " \t\r\n":
            i += 1
    return meta


def _fmt_value(key: str, val) -> str:
    if isinstance(val, (list, tuple, np.ndarray)):
        return "{ " + " , ".join(str(v) for v in val) + " }"
    if key == "description":
        return "{ " + str(val) + " }"
    return str(val)


def write_header(hdr_file: str, metadata) -> None:
    lines = ["ENVI"]
    for key, val in metadata.items():
        lines.append(f"{key} = {_fmt_value(key, val)}")
    with open(hdr_file, "w") as f:
        f.write("\n".join(lines) + "\n")


def _source_shape(nlines, nsamples, nbands, interleave):
    il = interleave.lower()
    if il == "bil":
        return (nlines, nbands, nsamples)
    if il == "bip":
        return (nlines, nsamples, nbands)
    if il == "bsq":
        return (nbands, nlines, nsamples)
    raise ValueError(f"unknown interleave: {interleave}")


def _to_bip_axes(interleave):
    """Transpose order mapping source-shape -> (lines, samples, bands)."""
    il = interleave.lower()
    return {"bil": (0, 2, 1), "bip": (0, 1, 2), "bsq": (1, 2, 0)}[il]


class EnviImage:
    """An ENVI image backed by a flat binary file + header.

    Mirrors the minimal spectral-python ``SpyFile`` surface the reference
    uses: ``shape`` (lines, samples, bands), ``metadata``, ``open_memmap``,
    ``load``, ``nrows/ncols/nbands``, ``bands.centers`` (wavelengths).
    """

    class _Bands:
        def __init__(self, centers):
            self.centers = centers

    def __init__(self, hdr_file: str, img_file: str, metadata=None):
        self.hdr_file = hdr_file
        self.img_file = img_file
        self.metadata = metadata if metadata is not None else read_header(hdr_file)
        m = self.metadata
        self.nrows = int(m["lines"])
        self.ncols = int(m["samples"])
        self.nbands = int(m["bands"])
        self.interleave = str(m.get("interleave", "bip")).lower()
        self.dtype = envi_to_dtype(int(m["data type"]), int(m.get("byte order", 0)))
        self.offset = int(m.get("header offset", 0))
        wl = m.get("wavelength")
        centers = [float(w) for w in wl] if wl else None
        self.bands = EnviImage._Bands(centers)

    @property
    def shape(self):
        return (self.nrows, self.ncols, self.nbands)

    @property
    def nodata(self):
        v = self.metadata.get("data ignore value")
        return float(v) if v is not None else None

    def open_memmap(self, interleave: str = "source", writable: bool = False):
        """Memmap of the raw file.

        ``interleave='source'`` returns the on-disk layout (like the
        reference's ``open_memmap(interleave='source')``,
        robust_mf.py:207); ``'bip'`` returns a (lines, samples, bands)
        view (transposed, zero-copy).
        """
        mode = "r+" if writable else "r"
        shape = _source_shape(self.nrows, self.ncols, self.nbands, self.interleave)
        mm = np.memmap(self.img_file, dtype=self.dtype, mode=mode,
                       offset=self.offset, shape=shape)
        if interleave == "source":
            return mm
        if interleave.lower() == "bip":
            return mm.transpose(_to_bip_axes(self.interleave))
        raise ValueError(f"unsupported interleave request: {interleave}")

    def _direct(self):
        if getattr(self, "_df", None) is None:
            from .directio import DirectFile
            self._df = DirectFile(self.img_file)
        return self._df

    def read_lines(self, r0: int, r1: int) -> np.ndarray:
        """Line block [r0, r1) as a (rows, samples, bands) array (a
        transpose view for BIL sources; materialize as needed). The
        streaming masks read (reference: masks_sds.py:289-296)."""
        item = self.dtype.itemsize
        if (self.interleave in ("bil", "bip") and self.offset % item == 0
                and 0 <= r0 <= r1 <= self.nrows):
            lb = self.ncols * self.nbands * item
            buf = self._direct().read_range(self.offset + r0 * lb, (r1 - r0) * lb)
            arr = buf.view(self.dtype)
            if self.interleave == "bil":
                return arr.reshape(r1 - r0, self.nbands, self.ncols).transpose(0, 2, 1)
            return arr.reshape(r1 - r0, self.ncols, self.nbands)
        return np.asarray(self.open_memmap(interleave="bip")[r0:r1])

    def read_band_window(self, b0: int, b1: int) -> np.ndarray:
        """Bands [b0, b1) of every line as (lines, b1-b0, samples) — the
        CMF's active-window read (reference: robust_mf.py:297-298 reads
        ``img_mm[:, active[0]-1:active[1], col]`` of a BIL cube). One
        contiguous extent per line for BIL; one extent in all for BSQ."""
        item = self.dtype.itemsize
        nb = b1 - b0
        if self.interleave == "bil" and self.offset % item == 0:
            lb = self.nbands * self.ncols * item
            ext = nb * self.ncols * item
            offs = [self.offset + li * lb + b0 * self.ncols * item
                    for li in range(self.nrows)]
            buf = self._direct().read_strided(offs, ext)
            return buf.view(self.dtype).reshape(self.nrows, nb, self.ncols)
        if self.interleave == "bsq" and self.offset % item == 0:
            plane = self.nrows * self.ncols * item
            buf = self._direct().read_range(self.offset + b0 * plane, nb * plane)
            return buf.view(self.dtype).reshape(nb, self.nrows, self.ncols).transpose(1, 0, 2)
        mm = self.open_memmap(interleave="source")
        if self.interleave == "bil":
            return np.ascontiguousarray(mm[:, b0:b1, :])
        if self.interleave == "bsq":
            return np.ascontiguousarray(mm[b0:b1].transpose(1, 0, 2))
        return np.ascontiguousarray(mm[:, :, b0:b1].transpose(0, 2, 1))

    def read_lines_bands(self, r0: int, r1: int, bands) -> np.ndarray:
        """Band subset of line block [r0, r1) as (rows, samples,
        len(bands)) (a transpose view for BIL sources), in the list's
        order. For BIL only the requested bands' bytes are read: bands
        adjacent in the list and in the file merge into runs, one extent
        per run per line."""
        bands = [int(b) for b in bands]
        item = self.dtype.itemsize
        nbsel = len(bands)
        if (self.interleave == "bil" and self.offset % item == 0
                and nbsel and 0 <= r0 <= r1 <= self.nrows):
            rows = r1 - r0
            out = np.empty((rows, nbsel, self.ncols), self.dtype)
            # each line's runs land in place: (rows, bands x samples) bytes
            dest = out.view(np.uint8).reshape(rows, nbsel * self.ncols * item)
            band_bytes = self.ncols * item
            lb = self.nbands * band_bytes
            df = self._direct()
            i = 0
            while i < nbsel:           # coalesce into contiguous runs
                j = i + 1
                while j < nbsel and bands[j] == bands[j - 1] + 1:
                    j += 1
                offs = [self.offset + li * lb + bands[i] * band_bytes
                        for li in range(r0, r1)]
                df.read_strided(offs, (j - i) * band_bytes,
                                out=dest[:, i * band_bytes:j * band_bytes])
                i = j
            return out.transpose(0, 2, 1)
        bip = self.open_memmap(interleave="bip")
        return np.asarray(bip[r0:r1][:, :, bands])

    def load(self) -> np.ndarray:
        """Whole cube as (lines, samples, bands), through the line reader
        where it applies."""
        try:
            return np.ascontiguousarray(self.read_lines(0, self.nrows))
        except OSError:
            return np.asarray(self.open_memmap(interleave="bip"))

    def read_band(self, b: int) -> np.ndarray:
        """One band as (lines, samples) — the detect stage's CMF-band read
        (reference: cnn_pred_pipeline.py loads band 4 of the CMF). BIL and
        BSQ read just that band's bytes; BIP reads lines."""
        if b < 0:
            b += self.nbands
        if not 0 <= b < self.nbands:
            raise IndexError(f"band {b} of {self.nbands}")
        if self.interleave in ("bil", "bsq"):
            return np.ascontiguousarray(self.read_band_window(b, b + 1)[:, 0, :])
        return np.ascontiguousarray(self.read_lines(0, self.nrows)[..., b])


def open_envi(file: str, image: str = None) -> EnviImage:
    """Open an ENVI image given a header or image path
    (reference: srcfinder_util.py:1041-1047 ``openimg``)."""
    if file.endswith(".hdr"):
        hdr = file
        img = image or _find_image(file)
    else:
        hdr = find_header(file)
        img = image or file
    if hdr is None or not os.path.isfile(hdr):
        raise FileNotFoundError(f"no ENVI header found for {file}")
    if img is None or not os.path.isfile(img):
        raise FileNotFoundError(f"no ENVI image found for {file}")
    return EnviImage(hdr, img)


def create_envi(hdr_file: str, metadata, force: bool = True, ext: str = "") -> EnviImage:
    """Create a zero-filled writable ENVI image from metadata
    (reference: robust_mf.py:261-263 ``envi_create_image``)."""
    meta = OrderedDict(metadata)
    nlines, nsamples, nbands = int(meta["lines"]), int(meta["samples"]), int(meta["bands"])
    meta.setdefault("header offset", 0)
    meta.setdefault("byte order", 0)
    meta.setdefault("file type", "ENVI Standard")
    interleave = str(meta.get("interleave", "bip"))
    dtype = envi_to_dtype(int(meta["data type"]), int(meta.get("byte order", 0)))

    base = hdr_file[:-4] if hdr_file.endswith(".hdr") else hdr_file
    img_file = base + ext
    if os.path.exists(img_file) and not force:
        raise FileExistsError(img_file)

    shape = _source_shape(nlines, nsamples, nbands, interleave)
    mm = np.memmap(img_file, dtype=dtype, mode="w+",
                   offset=int(meta["header offset"]), shape=shape)
    del mm  # flush zeros; callers re-open via open_memmap(writable=True)
    write_header(base + ".hdr", meta)
    return EnviImage(base + ".hdr", img_file, metadata=meta)


def save_envi(hdr_file: str, arr: np.ndarray, metadata=None, interleave: str = "bil",
              ext: str = "", force: bool = True) -> EnviImage:
    """Write a (lines, samples[, bands]) array as an ENVI image
    (reference: masks_sds.py:384 ``spectral.envi.save_image``,
    srcfinder_util.py:1341-1370 ``array2img``)."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    nlines, nsamples, nbands = arr.shape
    meta = OrderedDict(metadata or {})
    meta["lines"], meta["samples"], meta["bands"] = nlines, nsamples, nbands
    meta["interleave"] = interleave
    meta["data type"] = dtype_to_envi(arr.dtype)
    meta.setdefault("byte order", 0)
    meta.setdefault("header offset", 0)
    img = create_envi(hdr_file, meta, force=force, ext=ext)
    mm = img.open_memmap(interleave="bip", writable=True)
    mm[...] = arr
    if hasattr(mm, "flush"):
        mm.flush()
    elif hasattr(mm.base, "flush"):
        mm.base.flush()
    return img
