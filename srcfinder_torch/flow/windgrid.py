"""Wind grid I/O — the pygrib replacement.

The reference decodes HRRR/RTMA GRIB2 with pygrib/eccodes (C libraries,
msf_flow/wind_processor/windspeed.py:259-288; the Docker image builds
eccodes from source, msf_flow/Dockerfile:10-56). pygrib is not available
here, so wind grids are read through a small adapter:

- ``.npz``: keys lat, lon (2D), u, v, gust (2D), valid_date (ISO string)
  — the native interchange format of this framework.
- ``.grib2``: a pure-python GRIB2 decoder supporting grid definition
  templates 3.0 (regular lat/lon) and 3.30 (Lambert conformal — the
  actual HRRR/RTMA grid), and data representation templates 5.0 (simple
  packing), 5.2 (complex packing), 5.3 (complex packing with spatial
  differencing — the actual NCEP HRRR encoding), 5.40 (JPEG2000 — the
  actual NCEP RTMA encoding; decoded via Pillow/OpenJPEG) and 5.41
  (PNG), with bitmaps and primary missing-value management. pygrib can
  be registered via :func:`register_reader` when present.

GRIB2 stores negative integers sign-and-magnitude (MSB = sign), NOT
two's complement — all signed fields here go through ``_sm_int``.

The port's copy of the JAX package's ``flow/windgrid.py`` (host numpy, as
there): the same bytes decode to the same arrays, bit for bit.
"""

from __future__ import annotations

import datetime as _dt
import os
import struct
from typing import Callable, NamedTuple

import numpy as np

__all__ = ["WindGrid", "read_wind_grid", "write_wind_grid_npz",
           "register_reader", "read_grib2", "read_grib2_simple"]


class WindGrid(NamedTuple):
    lat: np.ndarray      # (ny, nx) degrees
    lon: np.ndarray      # (ny, nx) degrees
    u: np.ndarray        # (ny, nx) m/s at requested altitude
    v: np.ndarray        # (ny, nx) m/s
    gust: np.ndarray     # (ny, nx) m/s
    valid_date: _dt.datetime


_READERS: dict = {}


def register_reader(ext: str, fn: Callable[[str, int], WindGrid]):
    _READERS[ext] = fn


def read_wind_grid(path: str, alt: int = 10) -> WindGrid:
    """Read u/v/gust at ``alt`` meters (10 valid for HRRR+RTMA, 80 only
    HRRR — reference: windspeed.py:211-223)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _READERS:
        return _READERS[ext](path, alt)
    raise ValueError(f"no wind-grid reader for {ext} ({path})")


def _read_npz(path: str, alt: int) -> WindGrid:
    z = np.load(path, allow_pickle=False)
    suffix = "" if alt == 10 else f"_{alt}"
    try:
        u = z[f"u{suffix}"] if f"u{suffix}" in z else z["u"]
        v = z[f"v{suffix}"] if f"v{suffix}" in z else z["v"]
    except KeyError:
        raise KeyError(f"wind at altitude {alt} not found in {path}")
    if alt not in (10, 80):
        raise ValueError(f"Altitude {alt} not valid for recognized data types")
    vd = _dt.datetime.fromisoformat(str(z["valid_date"]))
    return WindGrid(z["lat"], z["lon"], u, v, z["gust"], vd)


def write_wind_grid_npz(path: str, grid: WindGrid, alt: int = 10):
    suffix = "" if alt == 10 else f"_{alt}"
    np.savez(path, lat=grid.lat, lon=grid.lon,
             **{f"u{suffix}": grid.u, f"v{suffix}": grid.v},
             gust=grid.gust, valid_date=grid.valid_date.isoformat())


# ----------------------------------------------------------------------
# pure-python GRIB2 decoder
# grid templates 3.0 (lat/lon) + 3.30 (Lambert conformal)
# data representation 5.0 (simple), 5.2 (complex), 5.3 (complex +
# spatial differencing) — the encodings real HRRR/RTMA products use
# (reference decodes via pygrib/eccodes: windspeed.py:259-288)
# ----------------------------------------------------------------------

def _sm_int(data: bytes) -> int:
    """GRIB2 signed integer: sign-and-magnitude, NOT two's complement."""
    val = int.from_bytes(data, "big")
    sign_bit = 1 << (len(data) * 8 - 1)
    if val & sign_bit:
        return -(val & (sign_bit - 1))
    return val


def _bits_to_uint(bits: np.ndarray, bit_offset: int, nbits: int,
                  count: int):
    """Read ``count`` big-endian ``nbits``-wide uints from an unpacked
    bit array."""
    if nbits == 0:
        return np.zeros(count, np.int64)
    sl = bits[bit_offset:bit_offset + nbits * count].reshape(count, nbits)
    weights = (1 << np.arange(nbits - 1, -1, -1)).astype(np.int64)
    return sl.astype(np.int64) @ weights


def _parse_drs(body: bytes) -> dict:
    """Parse section 5 (data representation) templates
    5.0/5.2/5.3/5.40/5.41."""
    tmpl = struct.unpack(">H", body[9:11])[0]
    if tmpl not in (0, 2, 3, 40, 41):
        raise ValueError(
            f"data representation template {tmpl} unsupported; "
            "convert to .npz or register pygrib")
    drs = {
        "template": tmpl,
        "npts": struct.unpack(">I", body[5:9])[0],
        "R": struct.unpack(">f", body[11:15])[0],
        "E": _sm_int(body[15:17]),
        "D": _sm_int(body[17:19]),
        "nbits": body[19],
    }
    if tmpl in (2, 3):
        drs.update({
            "missing_mgmt": body[22],
            "ngroups": struct.unpack(">I", body[31:35])[0],
            "ref_width": body[35],
            "bits_width": body[36],
            "ref_length": struct.unpack(">I", body[37:41])[0],
            "len_inc": body[41],
            "last_length": struct.unpack(">I", body[42:46])[0],
            "bits_length": body[46],
        })
    if tmpl == 3:
        drs["order"] = body[47]
        drs["extra_octets"] = body[48]
        if drs["missing_mgmt"] != 0:
            raise ValueError("missing-value management with spatial "
                             "differencing is unsupported")
    if tmpl == 40:
        drs["compression_type"] = body[21]       # 0 lossless, 1 lossy
    return drs


def _unpack_image(data: bytes, drs: dict, nvals: int) -> np.ndarray:
    """Templates 7.40/7.41: the field's scaled integers X are a JPEG2000
    codestream / PNG image; Y = (R + X*2^E)/10^D. Real NCEP RTMA2.5
    products use 5.40 (lossless JPEG2000); the reference reads them via
    pygrib/eccodes+openjpeg (msf_flow/Dockerfile:10-56). Decoded here
    with Pillow (OpenJPEG/libpng backends); eccodes likewise treats the
    decoded raster as a flat sequence of nvals values."""
    if drs["nbits"] == 0 or len(data) == 0:
        x = np.zeros(nvals, np.int64)
    else:
        try:
            from PIL import Image
        except ImportError as e:                       # pragma: no cover
            raise ValueError(
                f"template 5.{drs['template']} needs Pillow with "
                "JPEG2000/PNG support; convert to .npz or register "
                "pygrib") from e
        import io
        im = Image.open(io.BytesIO(data))
        x = np.asarray(im).astype(np.int64).ravel()
        if x.size < nvals:
            raise ValueError(
                f"image packing decoded {x.size} values, need {nvals}")
        x = x[:nvals]
    return (drs["R"] + x * 2.0 ** drs["E"]) / 10.0 ** drs["D"]


def _unpack_simple(data: bytes, drs: dict, nvals: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    packed = _bits_to_uint(bits, 0, drs["nbits"], nvals)
    return (drs["R"] + packed * 2.0 ** drs["E"]) / 10.0 ** drs["D"]


def _unpack_complex(data: bytes, drs: dict, nvals: int) -> np.ndarray:
    """Templates 7.2/7.3: group references/widths/lengths (each padded
    to a byte boundary) followed by the per-group packed values; 7.3
    prepends the spatial-differencing descriptors (first value(s) and
    the overall minimum of the differences, sign-and-magnitude)."""
    off = 0
    order = 0
    z0 = []
    gmin = 0
    if drs["template"] == 3:
        order = drs["order"]
        ds = drs["extra_octets"]
        for k in range(order):
            z0.append(_sm_int(data[off:off + ds]))
            off += ds
        gmin = _sm_int(data[off:off + ds])
        off += ds

    bits = np.unpackbits(np.frombuffer(data[off:], np.uint8))
    ng = drs["ngroups"]
    bit = 0
    refs = _bits_to_uint(bits, bit, drs["nbits"], ng)
    bit += drs["nbits"] * ng
    bit += (-bit) % 8
    widths = drs["ref_width"] + _bits_to_uint(bits, bit,
                                              drs["bits_width"], ng)
    bit += drs["bits_width"] * ng
    bit += (-bit) % 8
    lens = (drs["ref_length"]
            + _bits_to_uint(bits, bit, drs["bits_length"], ng)
            * drs["len_inc"])
    bit += drs["bits_length"] * ng
    bit += (-bit) % 8
    lens[-1] = drs["last_length"]
    if int(lens.sum()) != nvals:
        raise ValueError(f"group lengths sum {int(lens.sum())} != {nvals}")

    x = np.empty(nvals, np.float64)
    missing = np.zeros(nvals, bool)
    mgmt = drs["missing_mgmt"] if drs["template"] in (2, 3) else 0
    pos = 0
    for i in range(ng):
        n, w = int(lens[i]), int(widths[i])
        if w == 0:
            if mgmt == 1 and refs[i] == (1 << drs["nbits"]) - 1:
                missing[pos:pos + n] = True
                x[pos:pos + n] = 0
            else:
                x[pos:pos + n] = refs[i]
        else:
            vals = _bits_to_uint(bits, bit, w, n)
            bit += w * n
            if mgmt == 1:
                sentinel = (1 << w) - 1
                miss = vals == sentinel
                missing[pos:pos + n] = miss
                vals = np.where(miss, 0, vals)
            x[pos:pos + n] = refs[i] + vals
        pos += n

    if drs["template"] == 3:
        x[order:] += gmin
        x[:order] = z0
        if order == 1:
            x = np.cumsum(x)
        elif order == 2:
            for k in range(2, nvals):
                x[k] += 2.0 * x[k - 1] - x[k - 2]
        else:
            raise ValueError(f"spatial differencing order {order}")

    y = (drs["R"] + x * 2.0 ** drs["E"]) / 10.0 ** drs["D"]
    if mgmt:
        y[missing] = np.nan
    return y


def _earth_radius(body: bytes) -> float:
    shape = body[14]
    if shape == 0:
        return 6367470.0
    if shape == 1:
        scale, val = body[15], struct.unpack(">I", body[16:20])[0]
        return val / 10.0 ** scale
    if shape == 6:
        return 6371229.0
    # oblate shapes: use the authalic-ish mean; distance use only
    return 6371229.0


def _latlon_template0(body: bytes):
    ni = struct.unpack(">I", body[30:34])[0]
    nj = struct.unpack(">I", body[34:38])[0]
    la1 = _sm_int(body[46:50]) / 1e6
    lo1 = _sm_int(body[50:54]) / 1e6
    la2 = _sm_int(body[55:59]) / 1e6
    lo2 = _sm_int(body[59:63]) / 1e6
    lats = np.linspace(la1, la2, nj)
    lons = np.linspace(lo1, lo2, ni)
    lon2d, lat2d = np.meshgrid(lons, lats)
    return lat2d, lon2d, ni, nj


def _latlon_template30(body: bytes):
    """Lambert conformal conic (HRRR: Latin1=Latin2=38.5, LoV=262.5,
    spherical earth 6371229 m). Inverse-projects every grid node."""
    R = _earth_radius(body)
    nx = struct.unpack(">I", body[30:34])[0]
    ny = struct.unpack(">I", body[34:38])[0]
    la1 = _sm_int(body[38:42]) / 1e6
    lo1 = _sm_int(body[42:46]) / 1e6
    lad = _sm_int(body[47:51]) / 1e6
    lov = _sm_int(body[51:55]) / 1e6
    dx = struct.unpack(">I", body[55:59])[0] / 1e3
    dy = struct.unpack(">I", body[59:63])[0] / 1e3
    scan = body[64]
    latin1 = _sm_int(body[65:69]) / 1e6
    latin2 = _sm_int(body[69:73]) / 1e6

    phi1, phi2 = np.deg2rad(latin1), np.deg2rad(latin2)
    if abs(latin1 - latin2) < 1e-9:
        n = np.sin(phi1)
    else:
        n = (np.log(np.cos(phi1) / np.cos(phi2))
             / np.log(np.tan(np.pi / 4 + phi2 / 2)
                      / np.tan(np.pi / 4 + phi1 / 2)))
    F = np.cos(phi1) * np.tan(np.pi / 4 + phi1 / 2) ** n / n

    def rho(phi):
        return R * F / np.tan(np.pi / 4 + phi / 2) ** n

    rho0 = rho(np.deg2rad(lad))
    lam0 = np.deg2rad(lov)
    dlam1 = np.deg2rad(((lo1 - lov + 180.0) % 360.0) - 180.0)
    x1 = rho(np.deg2rad(la1)) * np.sin(n * dlam1)
    y1 = rho0 - rho(np.deg2rad(la1)) * np.cos(n * dlam1)
    sx = -1.0 if (scan & 0x80) else 1.0
    sy = 1.0 if (scan & 0x40) else -1.0
    x = x1 + sx * dx * np.arange(nx)
    y = y1 + sy * dy * np.arange(ny)
    X, Y = np.meshgrid(x, y)
    sgn = np.sign(n) if n != 0 else 1.0
    rho_g = sgn * np.hypot(X, rho0 - Y)
    theta = np.arctan2(sgn * X, sgn * (rho0 - Y))
    lat = np.rad2deg(2.0 * np.arctan((R * F / rho_g) ** (1.0 / n))
                     - np.pi / 2)
    lon = np.rad2deg(lam0 + theta / n)
    lon = ((lon + 180.0) % 360.0) - 180.0
    return lat, lon, nx, ny


def read_grib2(path: str, alt: int = 10) -> WindGrid:
    """Decode wind bands from a GRIB2 file.

    Parameter identification (discipline 0, category 2): u = number 2,
    v = 3, gust = 22; altitude from the fixed-surface scaled value of
    product template 4.0 (type 103 = height above ground) — the
    10 m / 80 m distinction the reference makes by band NAME via pygrib
    (windspeed.py:211-223) is made here by level value.
    """
    fields: dict = {}
    meta: dict = {}
    grid_body = None
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"GRIB":
        raise ValueError(f"{path}: not a GRIB2 file (no GRIB magic)")
    pos = 0
    while pos < len(blob):
        if blob[pos:pos + 4] != b"GRIB":
            break
        if pos + 16 > len(blob):
            raise ValueError(f"{path}: truncated GRIB2 indicator section "
                             f"at byte {pos}")
        total_len = struct.unpack(">Q", blob[pos + 8:pos + 16])[0]
        if total_len < 20 or pos + total_len > len(blob):
            raise ValueError(
                f"{path}: corrupt GRIB2 message length {total_len} at "
                f"byte {pos} (file has {len(blob) - pos} bytes left)")
        msg = blob[pos:pos + total_len]
        if msg[-4:] != b"7777":
            raise ValueError(f"{path}: GRIB2 message at byte {pos} does "
                             "not end with the 7777 terminator (truncated?)")
        pos += total_len
        i = 16
        grid = None
        prod = None
        drs = None
        bmp = None
        while i < len(msg) - 4:
            if msg[i:i + 4] == b"7777":
                break
            sec_len = struct.unpack(">I", msg[i:i + 4])[0]
            sec_num = msg[i + 4]
            # a zero/short section length would loop forever; one past
            # the message end is a truncation
            if sec_len < 5 or i + sec_len > len(msg):
                raise ValueError(
                    f"{path}: corrupt GRIB2 section {sec_num} length "
                    f"{sec_len} at message offset {i}")
            body = msg[i:i + sec_len]
            if sec_num == 1:
                year, month, day, hour, minute, sec = struct.unpack(
                    ">H5B", body[12:19])
                meta["valid_date"] = _dt.datetime(year, month, day, hour,
                                                  minute, sec)
            elif sec_num == 3:
                tmpl = struct.unpack(">H", body[12:14])[0]
                if tmpl == 0:
                    grid = _latlon_template0(body)
                elif tmpl == 30:
                    grid = _latlon_template30(body)
                else:
                    raise ValueError(f"grid template {tmpl} unsupported")
                grid_body = grid
            elif sec_num == 4:
                category, number = body[9], body[10]
                surf_type = body[22]
                scale = body[23]
                sval = _sm_int(body[24:28])
                level = sval / 10.0 ** _sm_int(bytes([scale])) \
                    if scale not in (0, 255) else sval
                prod = (category, number, surf_type, level)
            elif sec_num == 5:
                drs = _parse_drs(body)
            elif sec_num == 6:
                if body[5] != 255:
                    bmp = np.unpackbits(
                        np.frombuffer(body[6:], np.uint8)).astype(bool)
                elif body[5] == 255:
                    pass  # 254 = reuse previous: kept as-is
            elif sec_num == 7:
                if grid is None or drs is None or prod is None:
                    raise ValueError(
                        f"{path}: GRIB2 data section without preceding "
                        "grid/product/representation sections")
                lat2d, lon2d, ni, nj = grid
                npts = ni * nj
                nvals = int(bmp[:npts].sum()) if bmp is not None else npts
                if drs["template"] == 0:
                    vals = _unpack_simple(body[5:], drs, nvals)
                elif drs["template"] in (40, 41):
                    vals = _unpack_image(body[5:], drs, nvals)
                else:
                    vals = _unpack_complex(body[5:], drs, nvals)
                if bmp is not None:
                    full = np.full(npts, np.nan)
                    full[bmp[:npts]] = vals
                    vals = full
                fields[prod[:2] + (prod[3],)] = vals.reshape(nj, ni)
                bmp = None
            i += sec_len

    if grid_body is None:
        raise ValueError(f"{path}: no grid-definition section decoded "
                         "(empty or corrupt GRIB2)")
    if "valid_date" not in meta:
        raise ValueError(f"{path}: no identification section decoded")
    lat2d, lon2d, ni, nj = grid_body

    def pick(number):
        key = (2, number, float(alt))
        if key in fields:
            return fields[key]
        cands = [v for (c, n, lev), v in fields.items()
                 if (c, n) == (2, number)]
        if len(cands) == 1:
            return cands[0]
        raise KeyError(f"wind band (2,{number}) at {alt} m not found in "
                       f"{path} (levels: {sorted(set(k[2] for k in fields))})")

    return WindGrid(lat2d, lon2d, pick(2), pick(3), pick(22),
                    meta["valid_date"])


#: backward-compatible alias (the original decoder handled only simple
#: packing; :func:`read_grib2` is a superset)
read_grib2_simple = read_grib2


register_reader(".npz", _read_npz)
register_reader(".grib2", read_grib2)
register_reader(".grb2", read_grib2)
