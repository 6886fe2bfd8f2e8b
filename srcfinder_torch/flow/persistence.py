"""Source persistence: observed plumes / total overflights per source.

Reference (msf_flow/plume_processor/source_persistence/
source_persistence.py): count plumes per Source ID, count the flightline
polygons (an ESRI shapefile) containing each unique source point, and
report persistence = plumes/overflights (NaN for uncovered sources).

The reference needs fiona/GEOS to read the shapefile and test
``point.within(polygon)``; here a minimal pure-python ESRI Shapefile
polygon reader plus a vectorized ray-casting point-in-polygon replace
both. The port's copy of the JAX package's ``flow/persistence.py``.
"""

from __future__ import annotations

import struct

import numpy as np
import pandas as pd

__all__ = ["read_shapefile_polygons", "point_in_polygon",
           "plumes_per_source", "flightlines_per_source",
           "source_persistence"]


def read_shapefile_polygons(shp_path: str):
    """Minimal ESRI .shp reader for Polygon (type 5) records.

    Returns a list of polygons; each polygon is a list of rings, each ring
    an (n, 2) array of (x, y). Attribute names can be joined from the
    .dbf separately (only the geometry is needed for persistence).
    """
    with open(shp_path, "rb") as f:
        header = f.read(100)
        if struct.unpack(">i", header[:4])[0] != 9994:
            raise ValueError(f"not a shapefile: {shp_path}")
        polys = []
        while True:
            rec = f.read(8)
            if len(rec) < 8:
                break
            (_, content_len) = struct.unpack(">ii", rec)
            content = f.read(content_len * 2)
            shape_type = struct.unpack("<i", content[:4])[0]
            if shape_type == 0:          # null shape
                continue
            if shape_type not in (5, 15, 25):   # polygon variants
                continue
            num_parts, num_points = struct.unpack("<ii", content[36:44])
            parts = struct.unpack(f"<{num_parts}i",
                                  content[44:44 + 4 * num_parts])
            pts_off = 44 + 4 * num_parts
            pts = np.frombuffer(content[pts_off:pts_off + 16 * num_points],
                                dtype="<f8").reshape(num_points, 2)
            rings = []
            bounds = list(parts) + [num_points]
            for i in range(num_parts):
                rings.append(pts[bounds[i]:bounds[i + 1]].copy())
            polys.append(rings)
    return polys


def read_dbf_field(dbf_path: str, field: str):
    """Minimal dBASE III reader for one character/numeric field."""
    with open(dbf_path, "rb") as f:
        header = f.read(32)
        nrec = struct.unpack("<I", header[4:8])[0]
        hsize = struct.unpack("<H", header[8:10])[0]
        rsize = struct.unpack("<H", header[10:12])[0]
        fields = []
        while f.tell() < hsize - 1:
            fd = f.read(32)
            if fd[0:1] == b"\r":
                break
            name = fd[:11].split(b"\x00")[0].decode("ascii",
                                                    errors="replace")
            length = fd[16]
            fields.append((name, length))
        f.seek(hsize)
        vals = []
        offs = {}
        off = 1
        for name, length in fields:
            offs[name] = (off, length)
            off += length
        if field not in offs:
            raise KeyError(f"field {field} not in {list(offs)}")
        o, L = offs[field]
        for _ in range(nrec):
            rec = f.read(rsize)
            vals.append(rec[o:o + L].decode("ascii",
                                            errors="replace").strip())
    return vals


def point_in_polygon(px, py, rings) -> bool:
    """Even-odd ray casting over all rings (holes flip containment)."""
    inside = False
    for ring in rings:
        x = ring[:, 0]
        y = ring[:, 1]
        x2 = np.roll(x, -1)
        y2 = np.roll(y, -1)
        crosses = ((y <= py) != (y2 <= py))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x + (py - y) * (x2 - x) / (y2 - y)
        hit = crosses & (px < xint)
        if hit.sum() % 2 == 1:
            inside = not inside
    return inside


def plumes_per_source(sources, id_index: int = 0):
    """(reference: source_persistence.py:64-82)"""
    unique_srcs = []
    plume_freq = {}
    source_to_plumes = {}
    for source in sources:
        sid = source[id_index]
        if sid in plume_freq:
            source_to_plumes[sid].append(source)
            plume_freq[sid] += 1
        else:
            unique_srcs.append(source)
            source_to_plumes[sid] = [source]
            plume_freq[sid] = 1
    return plume_freq, unique_srcs, source_to_plumes


def flightlines_per_source(flightline_names, flightline_polys, source_ids,
                           source_xy):
    """Count flightline polygons containing each source point
    (reference: source_persistence.py:84-103)."""
    per_source = {}
    freq = {}
    for sid, (px, py) in zip(source_ids, source_xy):
        for name, rings in zip(flightline_names, flightline_polys):
            if point_in_polygon(px, py, rings):
                per_source.setdefault(sid, []).append(name)
                freq[sid] = freq.get(sid, 0) + 1
    return freq, per_source


def source_persistence(source_df: pd.DataFrame, flightline_names,
                       flightline_polys,
                       sid_key="Source identifier",
                       lat_key="Plume Latitude (deg)",
                       lon_key="Plume Longitude (deg)"):
    """Append observed.plumes / total.overflights / source.Persistence
    (reference: source_persistence.py:105-216). Flightline polygons are in
    lon/lat coordinates (points tested directly)."""
    rows = source_df[[sid_key]].values.tolist()
    plume_freq, _, _ = plumes_per_source(
        list(zip(source_df[sid_key].values)))
    uniq = source_df.drop_duplicates(subset=[sid_key])
    xy = list(zip(uniq[lon_key].astype(float), uniq[lat_key].astype(float)))
    freq, _ = flightlines_per_source(flightline_names, flightline_polys,
                                     uniq[sid_key].values, xy)
    out = uniq.copy()
    out["observed.plumes"] = [plume_freq[s] for s in out[sid_key]]
    out["total.overflights"] = [freq.get(s, np.nan) for s in out[sid_key]]
    out["source.Persistence"] = [
        plume_freq[s] / freq[s] if s in freq else np.nan
        for s in out[sid_key]]
    return out
