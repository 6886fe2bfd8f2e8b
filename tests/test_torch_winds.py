"""The port's wind stage (srcfinder_torch.flow.windgrid, .wind, .emission)
held against the JAX package's on the CPU.

- Wind grids: the port's GRIB2/npz reader returns the JAX reader's arrays
  bit for bit and the same valid date, over the encodings the JAX
  package's own tests write (tests/test_flow.py), and raises the same
  exception types on malformed files.
- Nearest cells: the port selects in float64 with ties to the lower cell
  index. It equals the JAX package's float32 selection where that one is
  determined (the golden grid, coarse grids); on an HRRR-spaced grid it is
  held index for index to a float64 numpy oracle (spherical cosines and a
  stable argsort), and the JAX package, whose float32 distance is
  quantised to ~2 km there, to that oracle within 3 km at the k-th
  distance.
- Wind statistics and emission rates: rtol 1e-12 on the coarse grids,
  indices and dates exact; the goldens (wind.npz, ime.npz) at their own
  rtol 1e-6.
"""

import datetime as dt
import os
import struct

import numpy as np
import pytest
import torch

from srcfinder_tpu.flow import emission as jemission
from srcfinder_tpu.flow import wind as jwind
from srcfinder_tpu.flow import windgrid as jwindgrid
from srcfinder_torch.flow import emission as temission
from srcfinder_torch.flow import wind as twind
from srcfinder_torch.flow import windgrid as twindgrid
from tests.test_flow import (_encode_complex_field, _encode_grib2_complex,
                             _encode_grib2_image, _encode_grib2_simple, _sm_bytes,
                             _tenths_grid)

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
T0 = dt.datetime(2020, 9, 24, 21, 0)


# ------------------------------------------------------------ wind grids
def _grib2_file(path, grid, fields, lambert=False):
    """A GRIB2 file of ``fields`` (sections 4-7 each) on ``grid``'s
    template 3.0 grid."""
    d = grid.valid_date
    sec1 = (struct.pack(">IB", 21, 1) + bytes(7)
            + struct.pack(">H5B", d.year, d.month, d.day, d.hour, d.minute,
                          d.second) + bytes(2))
    ny, nx = grid.u.shape
    sec3 = bytearray(72)
    sec3[0:4] = struct.pack(">I", 72)
    sec3[4] = 3
    sec3[30:34] = struct.pack(">I", nx)
    sec3[34:38] = struct.pack(">I", ny)
    sec3[46:50] = _sm_bytes(int(grid.lat[0, 0] * 1e6), 4)
    sec3[50:54] = _sm_bytes(int(grid.lon[0, 0] * 1e6), 4)
    sec3[55:59] = _sm_bytes(int(grid.lat[-1, 0] * 1e6), 4)
    sec3[59:63] = _sm_bytes(int(grid.lon[0, -1] * 1e6), 4)
    payload = sec1 + bytes(sec3) + b"".join(fields) + b"7777"
    with open(path, "wb") as f:
        f.write(b"GRIB" + bytes([0, 0, 0, 2]) + struct.pack(">Q", 16 + len(payload))
                + payload)


def _bitmap_field(number, values, present):
    """Complex packing with spatial differencing of the present values,
    behind a bitmap section."""
    body = _encode_complex_field(number, 10, values.ravel()[present], 2)
    bits = np.packbits(present.astype(np.uint8)).tobytes()
    sec6 = struct.pack(">IBB", 6 + len(bits), 6, 0) + bits
    at = 34 + 49                                  # sections 4 and 5 (5.3)
    assert body[at:at + 6] == struct.pack(">IBB", 6, 6, 255)
    return body[:at] + sec6 + body[at + 6:]


def _write_case(case, path, rng):
    g = _tenths_grid(rng, ny=11, nx=13)
    if case == "simple":
        g = twindgrid.WindGrid(g.lat, g.lon, np.full_like(g.u, 5.0),
                               np.full_like(g.v, 2.0), np.full_like(g.gust, 7.0),
                               g.valid_date)
        _encode_grib2_simple(path, g)
    elif case in ("complex", "order1", "order2"):
        _encode_grib2_complex(path, g, spatial_order={"complex": 0, "order1": 1,
                                                      "order2": 2}[case])
    elif case in ("j2k", "png"):
        pytest.importorskip("PIL")
        _encode_grib2_image(path, g, codec=case)
    elif case == "bitmap":
        present = np.ones(g.u.size, bool)
        present[-g.u.shape[1]:] = False            # the last row absent
        present[::7] = False
        _grib2_file(path, g, [_bitmap_field(n, f, present)
                              for n, f in ((2, g.u), (3, g.v), (22, g.gust))])
    elif case == "multilevel":
        _grib2_file(path, g, [_encode_complex_field(2, 10, g.u, 2),
                              _encode_complex_field(3, 10, g.v, 2),
                              _encode_complex_field(2, 80, g.u + 2.0, 2),
                              _encode_complex_field(3, 80, g.v - 1.5, 2),
                              _encode_complex_field(22, 10, g.gust, 2)])
    elif case == "lambert":
        _encode_grib2_complex(path, g, spatial_order=2, lambert=True)
    return g


def _assert_grids_equal(a, b):
    for name in ("lat", "lon", "u", "v", "gust"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.valid_date == b.valid_date


@pytest.mark.parametrize("case", ["simple", "complex", "order1", "order2", "j2k",
                                  "png", "bitmap", "multilevel", "lambert"])
def test_grib2_decode_equals_jax(tmp_path, case):
    rng = np.random.default_rng(11)
    p = str(tmp_path / "hrrr.2020092421.wrfsfcf00.grib2")
    g = _write_case(case, p, rng)
    alts = (10, 80) if case == "multilevel" else (10,)
    for alt in alts:
        got = twindgrid.read_wind_grid(p, alt=alt)
        _assert_grids_equal(got, jwindgrid.read_wind_grid(p, alt=alt))
    if case == "bitmap":
        assert np.isnan(got.u[-1]).all() and np.isfinite(got.u[0, 1:7]).all()
    elif case == "multilevel":
        np.testing.assert_allclose(got.u, g.u + 2.0, atol=1e-9)
    else:
        np.testing.assert_allclose(got.u, g.u, atol=1e-9)


def test_grib2_malformed_inputs_raise_as_jax(tmp_path):
    """The corruptions of tests/test_flow.py's malformed-input test, an
    unsupported packing, a missing altitude and an unknown extension:
    the port raises the JAX reader's exception type on each."""
    rng = np.random.default_rng(5)
    good = str(tmp_path / "good.grib2")
    _encode_grib2_complex(good, _tenths_grid(rng), spatial_order=2)
    blob = open(good, "rb").read()
    cases = {"notgrib.grib2": b"\x89PNG not a grib" * 4,
             "trunc.grib2": blob[: len(blob) // 2]}
    for name, at, fmt, val in (("zerosec.grib2", 16, ">I", 0),
                               ("longsec.grib2", 16, ">I", len(blob) + 1000),
                               ("badmsglen.grib2", 8, ">Q", len(blob) + 512),
                               ("badgridtmpl.grib2", 16 + 21 + 12, ">H", 999),
                               ("badpacking.grib2", 16 + 21 + 72 + 34 + 9, ">H", 4)):
        b = bytearray(blob)
        b[at:at + struct.calcsize(fmt)] = struct.pack(fmt, val)
        cases[name] = bytes(b)
    paths = []
    for name, data in cases.items():
        paths.append((str(tmp_path / name), 10))
        with open(paths[-1][0], "wb") as f:
            f.write(data)
    two = str(tmp_path / "two_levels.grib2")
    _encode_grib2_complex(two, _tenths_grid(rng), spatial_order=2, levels=(10, 80))
    paths += [(two, 50), (str(tmp_path / "w.txt"), 10)]
    for p, alt in paths:
        with pytest.raises(Exception) as jerr:
            jwindgrid.read_wind_grid(p, alt=alt)
        with pytest.raises(Exception) as terr:
            twindgrid.read_wind_grid(p, alt=alt)
        assert terr.type is jerr.type, (p, terr.value, jerr.value)
        assert terr.type in (ValueError, KeyError)


def test_npz_read_write_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    g = _tenths_grid(rng, ny=7, nx=9)
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jwindgrid.write_wind_grid_npz(jp, g)
    twindgrid.write_wind_grid_npz(tp, twindgrid.WindGrid(*g))
    g80 = twindgrid.WindGrid(g.lat, g.lon, g.u + 1, g.v - 1, g.gust, g.valid_date)
    p80 = str(tmp_path / "t80.npz")
    twindgrid.write_wind_grid_npz(p80, g80, alt=80)
    for p, alt in ((jp, 10), (jp, 80), (tp, 10), (tp, 80), (p80, 80)):
        _assert_grids_equal(twindgrid.read_wind_grid(p, alt=alt),
                            jwindgrid.read_wind_grid(p, alt=alt))
    np.testing.assert_array_equal(twindgrid.read_wind_grid(p80, alt=80).u, g80.u)
    for p, alt, err in ((tp, 50, ValueError), (p80, 10, KeyError)):
        for reader in (twindgrid.read_wind_grid, jwindgrid.read_wind_grid):
            with pytest.raises(err):
                reader(p, alt=alt)


# ---------------------------------------------------------- nearest cells
def _oracle(plume, grid, k):
    """float64 numpy spherical cosines over the F-order raveled grid and a
    stable argsort: distances and indices of the k nearest."""
    cells = np.c_[grid.lon.ravel(order="F"), grid.lat.ravel(order="F")]
    d = twind.distance_spherical([plume], cells, "sphericalCosines")[0]
    order = np.argsort(d, kind="stable")
    return d, order[:k]


def _regular_grid(lat0, lon0, ny, nx, dlat, dlon, jitter=0.0, seed=0):
    rng = np.random.default_rng(seed)
    lat = lat0 + (np.arange(ny) - ny // 2)[:, None] * dlat * np.ones((1, nx))
    lon = lon0 + (np.arange(nx) - nx // 2)[None, :] * dlon * np.ones((ny, 1))
    lat = lat + rng.uniform(-jitter, jitter, lat.shape) * dlat
    lon = lon + rng.uniform(-jitter, jitter, lon.shape) * dlon
    u = rng.normal(3.0, 0.7, lat.shape)
    v = rng.normal(4.0, 0.7, lat.shape)
    return twindgrid.WindGrid(lat, lon, u, v, np.abs(u) + 1, T0)


def _golden_grid():
    lat0, lon0 = 36.04, -119.53
    lats = np.linspace(lat0 - 1, lat0 + 1, 15)[:, None] * np.ones((1, 15))
    lons = np.linspace(lon0 - 1, lon0 + 1, 15)[None, :] * np.ones((15, 1))
    return (lon0, lat0), twindgrid.WindGrid(lats, lons, lats, lats, lats, T0)


@pytest.mark.parametrize("case", ["golden", "hrrr_spacing"])
def test_nearest_points_f64_lower_index_first(case):
    """golden: the 15 x 15 grid of tests/goldens/wind.npz, plume on a node,
    with an exact tie for the 10th cell (82 and 142, both 25.718 km away):
    the port picks JAX's 10 cells, the lower index. hrrr_spacing: a 300 x
    400 grid at 0.027 x 0.0334 deg (~3 km), plume 0.24 km from its nearest
    cell: the port equals the f64 oracle index for index; the JAX
    package's k-th selected distance, recomputed in f64, lies within 3 km
    of the oracle's."""
    k = 10
    if case == "golden":
        plume, g = _golden_grid()
    else:
        g = _regular_grid(36.04, -119.53, 300, 400, 0.027, 0.0334)
        plume = (-119.53 + 0.0012, 36.04 + 0.0015)
    d_all, want = _oracle(plume, g, k)
    d, idx = twind.nearest_points(plume, g, k, device="cpu")
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(d, d_all[want], rtol=1e-12)
    assert idx.dtype == np.int64 and d.dtype == np.float64
    _, jidx = jwind.nearest_points(plume, g, k)
    if case == "golden":
        # the same cells; JAX's f32 orders two other exact ties its own way
        np.testing.assert_array_equal(np.sort(idx), np.sort(jidx))
        assert {82, 142} & set(idx.tolist()) == {82}
        assert d_all[82] == d_all[142]
    else:
        assert abs(d_all[jidx[-1]] - d_all[want[-1]]) < 3.0
        assert d[0] < 0.25


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_nearest_points_stays_on_given_device(monkeypatch, device):
    """A grid far under the JAX package's 500k-cell host route is searched
    on the device passed in: a spy on the search's torch inputs sees them
    there (on "meta", a device without data, the spy stands in for the
    search)."""
    plume, g = _golden_grid()
    seen = []
    real = twind._nearest_k

    def spy(lon0, lat0, lons, lats, k):
        seen.append((type(lon0), type(lat0), lons.device, lats.device, lons.dtype,
                     lats.dtype))
        if lons.device.type == "meta":
            return torch.zeros(k, dtype=torch.float64), torch.arange(k)
        return real(lon0, lat0, lons, lats, k)
    monkeypatch.setattr(twind, "_nearest_k", spy)
    twind.nearest_points(plume, g, 3, device=device)
    assert g.lon.size < 500_000
    assert seen == [(float, float, torch.device(device), torch.device(device),
                     torch.float64, torch.float64)]


@pytest.mark.parametrize("kind", ["haversine", "sphericalCosines", "euclid"])
def test_distances_and_plume_reads_equal_jax(tmp_path, kind):
    rng = np.random.default_rng(8)
    x = np.c_[rng.uniform(-120, -118, 3), rng.uniform(35, 37, 3)]
    y = np.c_[rng.uniform(-120, -118, 40), rng.uniform(35, 37, 40)]
    np.testing.assert_array_equal(twind.distance_spherical(x, y, kind),
                                  jwind.distance_spherical(x, y, kind))
    dtype = "spherical" if kind == "sphericalCosines" else "euclid"
    for which in ("min", "max"):
        got = twind.distance_index(x[0], y, which, dtype)
        ref = jwind.distance_index(x[0], y, which, dtype)
        assert got[:2] == ref[:2]
        np.testing.assert_array_equal(got[2], ref[2])
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"p{i}.csv"))
        with open(files[-1], "w") as f:
            f.write("Candidate ID, Plume Latitude (deg)\n"
                    f"ang20200924t211102-{i}, 36.{i}\n")
    assert twind.gather_plumes(files) == jwind.gather_plumes(files)
    assert twind.read_plumes(files[1]) == [{"Candidate ID": "ang20200924t211102-1",
                                            "Plume Latitude (deg)": "36.1"}]


# ------------------------------------------------------- wind statistics
def write_coarse_winds(d, kind="hrrr", seed=7):
    """Three npz wind grids named as ``kind`` ("hrrr": hours 20-22 with 10 m
    and 80 m winds, u_80/v_80; "rtma": 21:00, 21:15, 21:30, 10 m only) on
    2020-09-24: jittered at ~0.4 deg around the tiny scene's plume, coarse
    enough that the JAX package's f32 selection is the f64 oracle's."""
    files = []
    for i, minute in enumerate((0, 15, 30) if kind == "rtma" else (0, 60, 120)):
        t = dt.datetime(2020, 9, 24, 20 if kind == "hrrr" else 21) \
            + dt.timedelta(minutes=minute)
        g = _regular_grid(36.04, -119.5, 12, 14, 0.4, 0.45, jitter=0.3,
                          seed=seed + i + (10 if kind == "rtma" else 0))
        if kind == "hrrr":
            name = f"hrrr.{t:%Y%m%d%H}.wrfsfcf00.npz"
            alt80 = dict(u_80=g.u + 1.0, v_80=g.v * 0.5)
        else:
            name = f"rtma2p5_ru.{t:%Y%m%d%H%M}z.2dvaranl_ndfd.npz"
            alt80 = {}
        files.append(os.path.join(d, name))
        np.savez(files[-1], lat=g.lat, lon=g.lon, u=g.u, v=g.v, gust=g.gust,
                 valid_date=t.isoformat(), **alt80)
    return files


def write_winds_dir(root):
    """``root``/hrrr/20200924 and ``root``/rtma/20200924, as the emission
    stage reads them. Returns the files."""
    files = []
    for kind in ("hrrr", "rtma"):
        day = os.path.join(root, kind, "20200924")
        os.makedirs(day)
        files += write_coarse_winds(day, kind)
    return files


def assert_jax_selection_is_oracle(plume, files, k=10):
    for f in files:
        g = twindgrid.read_wind_grid(f)
        _, want = _oracle(plume, g, k)
        np.testing.assert_array_equal(jwind.nearest_points(plume, g, k)[1], want)


@pytest.mark.parametrize("npoints,nfiles", [(1, 1), (1, 3), (10, 1), (10, 3)])
def test_wind_mnstd_cases_equal_jax(tmp_path, npoints, nfiles):
    """The four aggregation cases (case 2 with the recorded fix)."""
    files = write_coarse_winds(str(tmp_path))[:nfiles]
    plume = (-119.5123, 36.0431)
    assert_jax_selection_is_oracle(plume, files, npoints)
    got = twind.wind_mnstd(npoints, plume, files, device="cpu")
    ref = jwind.wind_mnstd(npoints, plume, files)
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-12)
    assert got[2] == ref[2] and isinstance(got[2], int)
    # the nearest distance: the f64 oracle's; JAX's f32 one within its
    # resolution
    g = twindgrid.read_wind_grid(files[-1])
    d_all, want = _oracle(plume, g, 1)
    np.testing.assert_allclose(got[3], d_all[want[0]], rtol=1e-12)
    assert abs(got[3] - ref[3]) < 3.0
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-12)
    assert got[5] == ref[5]
    if npoints == 1 and nfiles == 3:
        assert got[0] > 0 and got[1] > 0                        # the case-2 fix


@pytest.mark.parametrize("t,fmt,bh,bm", [
    ("20200924211102", "numericstring", 1, 1),
    ("20200924235959", "numericstring", 2, 0),
    ("20200101000730", "numericstring", 0, 2),
    ("8/21/2018 18:49:59 UTC", "utcstring", 1, -1),
    ("12/31/2019 23:52:30 UTC", "utcstring", -1, 1)])
def test_time_bucketing_equals_jax(t, fmt, bh, bm):
    assert twind.plumetime_format(t, fmt) == jwind.plumetime_format(t, fmt)
    assert twind.nearst_hm(t, bh, bm, fmt) == jwind.nearst_hm(t, bh, bm, fmt)


def test_time_format_error_equals_jax():
    for mod in (twind, jwind):
        with pytest.raises(ValueError):
            mod.plumetime_format("20200924", "julian")


# ------------------------------------------------------- emission rates
def _plume(**over):
    p = {"Candidate ID": "ang20200924t211102-1",
         "Plume Latitude (deg)": "36.0431", "Plume Longitude (deg)": "-119.5123",
         "AvgIMEdivFetch20 (kg/m)": "0.021", "StdIMEdivFetch20 (kg/m)": "0.004",
         "Aspect ratio20": "0.45"}
    p.update(over)
    return {k: v for k, v in p.items() if v is not None}


_PLUMES = {
    "complete": {},
    "nan_ime": {"AvgIMEdivFetch20 (kg/m)": "nan"},
    "empty_std": {"StdIMEdivFetch20 (kg/m)": ""},
    "fill_aspect": {"Aspect ratio20": "-9999"},
    "bad_aspect": {"Aspect ratio20": "1.5"},
    "no_ime": {"AvgIMEdivFetch20 (kg/m)": None, "StdIMEdivFetch20 (kg/m)": None},
    "fill_lat": {"Plume Latitude (deg)": "-9999"},
    "no_lon": {"Plume Longitude (deg)": None},
}


@pytest.mark.parametrize("fill", [None, "-9999"])
@pytest.mark.parametrize("name", sorted(_PLUMES))
def test_wind_stats_and_emission_equal_jax(tmp_path, fill, name):
    winds = tmp_path / "hrrr"
    day = winds / "20200924"
    os.makedirs(day)
    files = write_coarse_winds(str(day))
    plume = _plume(**_PLUMES[name])
    assert_jax_selection_is_oracle((-119.5123, 36.0431), files, 10)
    tplume, jplume = dict(plume), dict(plume)
    for alt in (10, 80):
        got = temission.compute_wind_stats(tplume, str(winds), fill=fill, wind_alt=alt,
                                           ext=".npz", device="cpu")
        ref = jemission.compute_wind_stats(jplume, str(winds), fill=fill, wind_alt=alt,
                                           ext=".npz")
        assert list(got) == list(ref)
        for k in got:
            if isinstance(ref[k], str):
                assert got[k] == ref[k]
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-12)
        tplume.update(got)
        jplume.update(ref)
    for alt in (10, 80):
        got = temission.compute_emission_rate(tplume, "HRRR", fill=fill, wind_alt=alt)
        ref = jemission.compute_emission_rate(jplume, "HRRR", fill=fill, wind_alt=alt)
        assert list(got) == list(ref)
        for k in got:
            if isinstance(ref[k], str):
                assert got[k] == ref[k], k
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)
    if name == "complete":
        er = got["Emission Rate (kg/hr) [HRRR 80 m]"]
        mean = tplume[temission.get_mean_wind_key("HRRR", 80, 10, 3)]
        assert er == pytest.approx(0.021 * mean * 3600, rel=1e-12)
    assert temission.WindType(str(winds)).type_as_str() == "HRRR"
    with pytest.raises(ValueError):
        temission.compute_wind_stats(plume, str(tmp_path), device="cpu")


# --------------------------------------------------------------- goldens
def test_wind_golden_through_the_port():
    """tests/goldens/wind.npz (tests/test_goldens.py::_wind_case) through
    the port's WindGrid, npz writer, wind_mnstd and compute_emission_rate."""
    import tempfile
    rng = np.random.default_rng(12345)
    plume, g = _golden_grid()
    with tempfile.TemporaryDirectory() as d:
        files = []
        for h in (20, 21, 22):
            grid = twindgrid.WindGrid(g.lat, g.lon,
                                      rng.normal(3.0, 0.7, g.lat.shape),
                                      rng.normal(4.0, 0.7, g.lat.shape),
                                      rng.normal(6.0, 0.7, g.lat.shape),
                                      dt.datetime(2020, 9, 24, h))
            p = os.path.join(d, f"hrrr.20200924{h:02d}.wrfsfcf00.npz")
            twindgrid.write_wind_grid_npz(p, grid)
            files.append(p)
        mean, std = twind.wind_mnstd(10, plume, files, device="cpu")[:2]
    stats = temission.compute_emission_rate(
        {"AvgIMEdivFetch20 (kg/m)": 0.02, "StdIMEdivFetch20 (kg/m)": 0.005,
         "Aspect ratio20": 0.5,
         temission.get_mean_wind_key("hrrr", 10, 10, 3): mean,
         temission.get_std_wind_key("hrrr", 10, 10, 3): std}, "hrrr")
    er = [float(v) for k, v in stats.items() if "Emission" in k]
    ref = np.load(os.path.join(GOLDEN_DIR, "wind.npz"))
    np.testing.assert_allclose([mean, std], ref["a00"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(er, ref["a01"], rtol=1e-6, atol=1e-9)


def test_ime_golden_through_the_port():
    """tests/goldens/ime.npz (tests/test_goldens.py::_ime_case) through the
    port's detection_ime_stats."""
    from srcfinder_torch.flow.ime_worker import detection_ime_stats
    rng = np.random.default_rng(12345)
    cmf = rng.normal(200.0, 150.0, (64, 48)).astype(np.float32)
    cmf[10:16, 10:15] = 2500.0
    cmf[18:21, 18:20] = 3200.0
    cmf[40:44, 30:33] = 1800.0
    cmf[0, :] = -9999.0
    m = dict(proj="UTM", ulx=391000.0, uly=3786000.0, xps=3.0, yps=3.0,
             zone="11", hemi="North", rotation=0.0)
    df = detection_ime_stats(cmf, m)
    ref = np.load(os.path.join(GOLDEN_DIR, "ime.npz"))
    cols = ["mergedist_m", "plume", "area_px", "ime_kg", "fetch_m",
            "ime_div_fetch", "aspect", "row", "col", "lat", "lon"]
    assert len(ref.files) == len(cols)
    for i, c in enumerate(cols):
        np.testing.assert_allclose(df[c].to_numpy(np.float64), ref[f"a{i:02d}"],
                                   rtol=1e-6, atol=1e-9, err_msg=c)
