"""Minimal self-contained GeoTIFF writer/reader with LZW.

The reference writes GeoTIFF products through GDAL (reference:
srcfinder_util.py:1169-1208 ``gdalwrite``, :1075-1092 ``prob2geotiff``,
:1226-1335 ``tile2geotiff``, :1977-1987 ``labimg2tif``) and its CNN
saliency maps LZW-compressed (cnn/cnn_pred_pipeline.py:191-202).
GDAL/rasterio are not available here, so this module emits striped
(Geo)TIFFs directly: baseline TIFF 6.0 tags + the GeoTIFF
ModelPixelScale/ModelTiepoint/GeoKeyDirectory keys for UTM (WGS-84) and
Geographic lat/lon rasters, plus the GDAL_NODATA tag, optionally
LZW-compressed (TIFF 6.0 LZW with the libtiff "early change" code-width
rule). The reader round-trips them and reads other contiguous TIFFs
(compression none/LZW, horizontal predictor supported).

Port of the JAX package's ``core/geotiff.py``: the same bytes for the same
array, tags and compression. Every LZW strip, written or read, goes
through the port's native codec (:mod:`.native`), which releases the
interpreter lock; ``_lzw_encode_py`` and ``_lzw_decode_py`` are its plain
versions, which the tests hold it to.
"""

from __future__ import annotations

import struct

import numpy as np

from .native import lzw_decode, lzw_encode

__all__ = ["write_geotiff", "read_geotiff", "mapinfo_to_geotransform"]

_SAMPLE_FORMAT = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 1,
                  np.dtype(np.uint32): 1, np.dtype(np.int16): 2,
                  np.dtype(np.int32): 2, np.dtype(np.float32): 3,
                  np.dtype(np.float64): 3}

_TYPE_SHORT, _TYPE_LONG, _TYPE_RATIONAL, _TYPE_ASCII, _TYPE_DOUBLE = \
    3, 4, 5, 2, 12


_CLEAR, _EOI, _FIRST = 256, 257, 258


def _lzw_encode_py(data: bytes) -> bytes:
    """TIFF 6.0 LZW (MSB-first bit packing, early code-width change).

    The string table is keyed by (prefix code, next byte) packed in one
    int, the single bytes being codes 0-255, and the bit packing is
    inline: the same codes as a table of byte strings, at about half the
    interpreter time."""
    out = bytearray()
    append = out.append
    buf, nbuf = _CLEAR, 9
    table: dict = {}
    get = table.get
    nxt, bits = _FIRST, 9
    cur = -1
    for byte in data:
        if cur < 0:
            cur = byte
            continue
        key = (cur << 8) | byte
        code = get(key)
        if code is not None:
            cur = code
            continue
        buf = (buf << bits) | cur
        nbuf += bits
        while nbuf >= 8:
            nbuf -= 8
            append((buf >> nbuf) & 0xFF)
        buf &= (1 << nbuf) - 1
        table[key] = nxt
        nxt += 1
        # width bump calibrated against libtiff (PIL cross-checked in
        # tests): encoder at nxt == 2^bits, decoder one entry earlier
        # (its table lags by one) at len == 2^bits - 1
        if nxt == 4094:                 # table nearly full: restart
            buf = (buf << bits) | _CLEAR
            nbuf += bits
            while nbuf >= 8:
                nbuf -= 8
                append((buf >> nbuf) & 0xFF)
            buf &= (1 << nbuf) - 1
            table.clear()
            nxt, bits = _FIRST, 9
        elif nxt == (1 << bits) and bits < 12:
            bits += 1
        cur = byte
    if cur >= 0:
        buf = (buf << bits) | cur
        nbuf += bits
    buf = (buf << bits) | _EOI
    nbuf += bits
    while nbuf >= 8:
        nbuf -= 8
        append((buf >> nbuf) & 0xFF)
    if nbuf:
        append((buf << (8 - nbuf)) & 0xFF)
    return bytes(out)


def _lzw_decode_py(data: bytes) -> bytes:
    """Inverse of :func:`_lzw_encode_py`; also reads libtiff/GDAL
    output."""
    out = bytearray()
    pos = 0
    buf = 0
    nbuf = 0
    bits = 9
    table: list = [bytes([i]) for i in range(256)] + [b"", b""]
    prev = None

    while True:
        while nbuf < bits:
            if pos >= len(data):
                return bytes(out)
            buf = (buf << 8) | data[pos]
            pos += 1
            nbuf += 8
        nbuf -= bits
        code = (buf >> nbuf) & ((1 << bits) - 1)
        buf &= (1 << nbuf) - 1

        if code == _EOI:
            return bytes(out)
        if code == _CLEAR:
            table = table[:_FIRST]
            bits = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(table[prev] + entry[:1])
        elif code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW stream (code {code})")
        out += entry
        # width bump one entry before the encoder's (the decoder table
        # lags by one entry) — matches libtiff ("early change")
        if len(table) == (1 << bits) - 1 and bits < 12:
            bits += 1
        prev = code


def _undo_predictor2(arr: np.ndarray) -> np.ndarray:
    """TIFF horizontal differencing predictor (tag 317 = 2)."""
    return np.cumsum(arr.astype(np.int64), axis=1).astype(arr.dtype) \
        if arr.dtype.kind in "ui" else np.cumsum(arr, axis=1)


def mapinfo_to_geotransform(m):
    """ENVI map-info dict -> (ulx, xps, 0, uly, 0, -yps) GDAL-style
    geotransform (rotation unsupported in the plain tie-point model)."""
    return (float(m["ulx"]), float(m["xps"]), 0.0,
            float(m["uly"]), 0.0, -float(m["yps"]))


def _geokeys(m):
    """GeoKeyDirectory entries for UTM/WGS-84 or Geographic rasters."""
    keys = []
    proj = str(m.get("proj", "")).upper() if m else ""
    if proj == "UTM":
        from .geo import utmzone2epsg
        hemi = "N" if str(m["hemi"]).upper().startswith("N") else "S"
        epsg = utmzone2epsg(int(m["zone"]), hemi)
        keys = [(1024, 0, 1, 1),      # GTModelType = projected
                (1025, 0, 1, 1),      # GTRasterType = PixelIsArea
                (3072, 0, 1, epsg)]   # ProjectedCSType
    elif proj:
        keys = [(1024, 0, 1, 2),      # GTModelType = geographic
                (1025, 0, 1, 1),
                (2048, 0, 1, 4326)]   # GeographicType = WGS 84
    return keys


def write_geotiff(path, arr, mapinfo=None, nodata=None, compress=None,
                  geotransform=None, epsg=None):
    """Write (H, W) or (H, W, bands) as a GeoTIFF.

    ``mapinfo``: ENVI map-info dict (see core.geo.mapinfo) or None for a
    plain TIFF. Rotation is not representable with tie-point+scale; pass
    rotation=0 imagery (the reference shells ``gdalwarp`` to north-up for
    the same reason, cmftagger/util.py:408-489).
    ``compress``: None or "lzw" (the reference's saliency export mode,
    cnn/cnn_pred_pipeline.py:191-202).
    ``geotransform``/``epsg``: direct georeferencing override (e.g. the
    EPSG:3857 web-mercator cache, qc/gtif.py) instead of ``mapinfo``.
    """
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, bands = arr.shape
    dt = arr.dtype
    if dt == np.bool_:
        arr = arr.astype(np.uint8)
        dt = arr.dtype
    if dt not in _SAMPLE_FORMAT:
        raise ValueError(f"unsupported dtype {dt}")
    bps = dt.itemsize * 8
    data = np.ascontiguousarray(arr).tobytes()
    if compress not in (None, "none", "lzw"):
        raise ValueError(f"unsupported compression {compress!r}")
    lzw = compress == "lzw"
    if lzw:
        data = lzw_encode(data)

    entries = []          # (tag, type, count, value_or_bytes)

    def tag(t, typ, count, value):
        entries.append((t, typ, count, value))

    tag(256, _TYPE_LONG, 1, w)              # ImageWidth
    tag(257, _TYPE_LONG, 1, h)              # ImageLength
    tag(258, _TYPE_SHORT, bands,
        struct.pack(f"<{bands}H", *([bps] * bands)))
    tag(259, _TYPE_SHORT, 1, 5 if lzw else 1)   # Compression
    tag(262, _TYPE_SHORT, 1, 1)             # Photometric = BlackIsZero
    tag(273, _TYPE_LONG, 1, None)           # StripOffsets (patched)
    tag(277, _TYPE_SHORT, 1, bands)         # SamplesPerPixel
    tag(278, _TYPE_LONG, 1, h)              # RowsPerStrip = whole image
    tag(279, _TYPE_LONG, 1, len(data))      # StripByteCounts
    tag(284, _TYPE_SHORT, 1, 1)             # PlanarConfig = contiguous
    sf = _SAMPLE_FORMAT[dt]
    tag(339, _TYPE_SHORT, bands,
        struct.pack(f"<{bands}H", *([sf] * bands)))

    if mapinfo or geotransform is not None:
        gt = geotransform if geotransform is not None \
            else mapinfo_to_geotransform(mapinfo)
        tag(33550, _TYPE_DOUBLE, 3,
            struct.pack("<3d", gt[1], -gt[5], 0.0))          # pixel scale
        tag(33922, _TYPE_DOUBLE, 6,
            struct.pack("<6d", 0, 0, 0, gt[0], gt[3], 0))    # tiepoint
        if epsg is not None:
            keys = [(1024, 0, 1, 1), (1025, 0, 1, 1),
                    (3072, 0, 1, int(epsg))]
        else:
            keys = _geokeys(mapinfo)
        if keys:
            kd = [(1, 1, 0, len(keys))] + keys
            flat = [v for k in kd for v in k]
            tag(34735, _TYPE_SHORT, len(flat),
                struct.pack(f"<{len(flat)}H", *flat))
    if nodata is not None:
        s = (f"{nodata}").encode() + b"\x00"
        tag(42113, _TYPE_ASCII, len(s), s)

    entries.sort(key=lambda e: e[0])

    # layout: header(8) + IFD + out-of-line values + pixel data
    ifd_off = 8
    ifd_size = 2 + len(entries) * 12 + 4
    extra_off = ifd_off + ifd_size
    extra = bytearray()
    packed = []
    for t, typ, count, value in entries:
        if isinstance(value, (bytes, bytearray)):
            if len(value) <= 4:
                packed.append((t, typ, count,
                               bytes(value) + b"\x00" * (4 - len(value))))
            else:
                packed.append((t, typ, count,
                               struct.pack("<I", extra_off + len(extra))))
                extra.extend(value)
        elif value is None:
            packed.append((t, typ, count, None))  # patched later
        else:
            fmt = "<I" if typ == _TYPE_LONG else "<HH"
            packed.append((t, typ, count,
                           struct.pack("<I", value) if typ == _TYPE_LONG
                           else struct.pack("<HH", value, 0)))
    data_off = extra_off + len(extra)

    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd_off))
        f.write(struct.pack("<H", len(packed)))
        for t, typ, count, value in packed:
            if value is None:                      # StripOffsets
                value = struct.pack("<I", data_off)
            f.write(struct.pack("<HHI", t, typ, count) + value)
        f.write(struct.pack("<I", 0))              # next IFD
        f.write(bytes(extra))
        f.write(data)
    return path


_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 12: 8, 11: 4}
_NP_FROM_SF = {(1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
               (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
               (3, 32): np.float32, (3, 64): np.float64}


def read_geotiff(path):
    """Read a contiguous striped TIFF (compression none or LZW,
    horizontal predictor honored). Returns (array (H, W[, bands]), meta
    dict with geotransform/epsg/nodata when present)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] != b"II":
        raise ValueError("only little-endian TIFFs supported")
    ifd_off = struct.unpack("<I", blob[4:8])[0]
    n = struct.unpack("<H", blob[ifd_off:ifd_off + 2])[0]
    tags = {}
    for i in range(n):
        off = ifd_off + 2 + i * 12
        t, typ, count = struct.unpack("<HHI", blob[off:off + 8])
        size = _TYPE_SIZE.get(typ, 1) * count
        if size <= 4:
            raw = blob[off + 8:off + 8 + size]
        else:
            voff = struct.unpack("<I", blob[off + 8:off + 12])[0]
            raw = blob[voff:voff + size]
        tags[t] = (typ, count, raw)

    def val(t, default=None):
        if t not in tags:
            return default
        typ, count, raw = tags[t]
        if typ == _TYPE_SHORT:
            v = struct.unpack(f"<{count}H", raw)
        elif typ == _TYPE_LONG:
            v = struct.unpack(f"<{count}I", raw)
        elif typ == _TYPE_DOUBLE:
            v = struct.unpack(f"<{count}d", raw)
        elif typ == _TYPE_ASCII:
            return raw.rstrip(b"\x00").decode()
        else:
            return raw
        return v[0] if count == 1 else v

    w, h = val(256), val(257)
    bands = val(277, 1)
    comp = val(259, 1)
    if comp not in (1, 5):
        raise ValueError(f"compression {comp} not supported (none/LZW)")
    bps = val(258)
    bps = bps[0] if isinstance(bps, tuple) else bps
    sf = val(339, 1)
    sf = sf[0] if isinstance(sf, tuple) else sf
    dt = np.dtype(_NP_FROM_SF[(sf, bps)])
    offsets = val(273)
    offsets = (offsets,) if isinstance(offsets, int) else offsets
    counts = val(279)
    counts = (counts,) if isinstance(counts, int) else counts
    strips = [blob[o:o + c] for o, c in zip(offsets, counts)]
    if comp == 5:
        rows = val(278, h)
        row_bytes = w * bands * dt.itemsize
        strips = [lzw_decode(s, max(0, min(rows, h - i * rows)) * row_bytes)
                  for i, s in enumerate(strips)]
    buf = b"".join(strips)
    arr = np.frombuffer(buf, dt).reshape(h, w, bands)
    predictor = val(317, 1)
    if predictor == 2:
        arr = _undo_predictor2(arr)
    elif predictor not in (1, 2):
        raise ValueError(f"predictor {predictor} not supported")
    if bands == 1:
        arr = arr[:, :, 0]

    meta = {}
    scale = val(33550)
    tie = val(33922)
    if scale and tie:
        meta["geotransform"] = (tie[3], scale[0], 0.0, tie[4], 0.0,
                                -scale[1])
    gk = val(34735)
    if gk:
        keys = np.array(gk).reshape(-1, 4)
        for kid, _, _, kval in keys[1:]:
            if kid == 3072:
                meta["epsg"] = int(kval)
            if kid == 2048:
                meta["epsg"] = int(kval)
    nod = val(42113)
    if nod is not None:
        meta["nodata"] = float(nod)
    return arr, meta
