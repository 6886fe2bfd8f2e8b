"""The port's msf-flow stage modules and their entry points
(srcfinder_torch.flow: cluster, dedup, persistence, inversion,
wind_export, harvester, utils, deploy's job-spec runner, stage_clis) and
the ``python -m srcfinder_torch`` dispatcher, held against the JAX
package's on the same numpy-seeded inputs, on the CPU.

Tolerances: host stages exactly (mappings, frames and written files
equal); the inversion in float32 within 1e-4 of the largest entry's
magnitude (the JAX functions run in float32 under jit with 64-bit mode
off, and the factorisations round differently: JAX takes an upper
Cholesky factor, torch a lower one); NetCDF values exactly. No network:
the harvester fetches file:// URLs and the station lookups take a fake
fetch.
"""

import csv
import datetime as dt
import importlib
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import srcfinder_tpu.flow as jflow
import srcfinder_torch.flow as tflow
from srcfinder_tpu.flow import dedup as jdedup
from srcfinder_tpu.flow import deploy as jdeploy
from srcfinder_tpu.flow import harvester as jharvester
from srcfinder_tpu.flow import inversion as jinv
from srcfinder_tpu.flow import persistence as jpers
from srcfinder_tpu.flow import stage_clis as jclis
from srcfinder_tpu.flow import stations as jstations
from srcfinder_tpu.flow import utils as jutils
from srcfinder_tpu.flow import wind_export as jexport
from srcfinder_torch import __main__ as tmain
from srcfinder_torch.flow import dedup as tdedup
from srcfinder_torch.flow import deploy as tdeploy
from srcfinder_torch.flow import harvester as tharvester
from srcfinder_torch.flow import inversion as tinv
from srcfinder_torch.flow import persistence as tpers
from srcfinder_torch.flow import stage_clis as tclis
from srcfinder_torch.flow import stations as tstations
from srcfinder_torch.flow import utils as tutils
from srcfinder_torch.flow import wind_export as texport
from tests.test_flow import _write_dbf, make_grid, write_grid
from tests.test_torch_winds import assert_jax_selection_is_oracle, write_winds_dir

# the packages export a function ``cluster`` under the module's name
jcluster = importlib.import_module("srcfinder_tpu.flow.cluster")
tcluster = importlib.import_module("srcfinder_torch.flow.cluster")

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS_JSON = os.path.join(ROOT, "deployment", "jobs.json")
GOLDEN = os.path.join(ROOT, "tests", "goldens", "dedup.npz")
LAT, LON = "Plume Latitude (deg)", "Plume Longitude (deg)"
FLUX = "Emission Rate (kg/hr) [HRRR 10 m]"
#: the inversion's bound: |port - JAX| <= INV_TOL * max |JAX| (float32)
INV_TOL = 1e-4


def _files_equal(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


# ----------------------------------------------------------------- fixtures
def _plumes(rng, n=40, nsrc=8, lines=3):
    """A seeded plume list: ``n`` plumes scattered ~20 m around ``nsrc``
    sources, seen from ``lines`` flightlines, with fluxes (one NaN and one
    "#VALUE!" among them) and a fill row."""
    src = np.c_[rng.uniform(31.0, 31.2, nsrc), rng.uniform(-102.5, -102.2, nsrc)]
    pick = rng.integers(0, nsrc, n)
    lat = src[pick, 0] + rng.normal(0, 2e-4, n)
    lon = src[pick, 1] + rng.normal(0, 2e-4, n)
    line = np.array([f"ang2021091{k}t1{k}0000" for k in range(lines)])[
        rng.integers(0, lines, n)]
    flux = np.round(rng.lognormal(5.0, 0.8, n), 3).astype(object)
    flux[3], flux[7] = np.nan, "#VALUE!"
    df = pd.DataFrame({"Candidate ID": [f"{l}-{i}" for i, l in enumerate(line)],
                       "Line name": line, LAT: np.round(lat, 6), LON: np.round(lon, 6),
                       FLUX: flux})
    df[[LAT, LON]] = df[[LAT, LON]].astype(object)
    df.loc[n - 1, [LAT, LON]] = "-9999"
    return df


def _write_shp(path, polygons):
    """An ESRI .shp of Polygon records; each polygon a list of (k, 2) rings
    (a ring after the first is a hole)."""
    recs = b""
    allpts = np.concatenate([r for p in polygons for r in p])
    for i, rings in enumerate(polygons):
        pts = np.concatenate(rings)
        parts = np.cumsum([0] + [len(r) for r in rings[:-1]])
        content = (struct.pack("<i", 5) + struct.pack("<4d", *pts.min(0), *pts.max(0))
                   + struct.pack("<ii", len(rings), len(pts))
                   + struct.pack(f"<{len(rings)}i", *parts)
                   + pts.astype("<f8").tobytes())
        recs += struct.pack(">ii", i + 1, len(content) // 2) + content
    header = (struct.pack(">i", 9994) + bytes(20) + struct.pack(">i", (100 + len(recs)) // 2)
              + struct.pack("<ii", 1000, 5)
              + struct.pack("<8d", *allpts.min(0), *allpts.max(0), 0, 0, 0, 0))
    with open(path, "wb") as f:
        f.write(header + recs)


def _square(x0, y0, w):
    return np.array([[x0, y0], [x0, y0 + w], [x0 + w, y0 + w], [x0 + w, y0], [x0, y0]],
                    float)


FLIGHTLINES = [[_square(-102.6, 30.9, 0.5), _square(-102.45, 31.0, 0.1)],   # a hole
               [_square(-102.4, 31.05, 0.3)],
               [_square(-102.3, 30.95, 0.2), _square(-102.25, 31.0, 0.05)]]


@pytest.fixture
def shapefile(tmp_path):
    shp = str(tmp_path / "flightlines.shp")
    _write_shp(shp, FLIGHTLINES)
    _write_dbf(tmp_path / "flightlines.dbf", "Flight_Run",
               ["ang20210910t100000", "ang20210911t110000", "ang20210912t120000"],
               width=20)
    return shp


# ----------------------------------------------------------------- names
def test_flow_public_names_have_port_counterparts():
    missing = [n for n in dir(jflow) if not n.startswith("_") and not hasattr(tflow, n)]
    assert missing == []
    assert tflow.IME_JOB_DEFAULTS == jflow.IME_JOB_DEFAULTS


def test_package_names_load_on_first_use(tmp_path, rng):
    """``srcfinder_torch.flow`` and ``.core`` import a module at the first
    use of one of its names: a host stage's process (cluster) imports no
    torch, the inversion's does."""
    p = str(tmp_path / "p.csv")
    _plumes(rng).to_csv(p, index=False)
    code = ("import sys, srcfinder_torch.flow as f, srcfinder_torch.core as c; "
            "assert 'torch' not in sys.modules and 'pandas' not in sys.modules; "
            "from srcfinder_torch.__main__ import main; "
            f"assert main(['cluster', {p!r}, {str(tmp_path / 'o.csv')!r}, '-r', '150']) == 0; "
            "assert 'torch' not in sys.modules; "
            "assert f.cluster is f.cluster_plume_list.__globals__['cluster']; "
            "assert callable(c.latlon2sl) and 'torch' not in sys.modules; "
            "f.ols_inversion; assert 'torch' in sys.modules; "
            "assert 'windgrid' in dir(f) and f.windgrid.WindGrid is f.WindGrid")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=ROOT))


# ----------------------------------------------------------------- cluster
@pytest.mark.parametrize("radius", [20.0, 150.0, 5000.0])
def test_cluster_equals_jax(rng, radius):
    pts = np.c_[rng.uniform(0, 2000, 60), rng.uniform(0, 2000, 60)]
    pts[30:] = pts[:30] + rng.normal(0, 10, (30, 2))
    got = tcluster.cluster(pts, radius=radius)
    assert got == jcluster.cluster(pts, radius=radius)
    assert tcluster.source_num_to_str(12, "B") == jcluster.source_num_to_str(12, "B")


def test_cluster_plume_list_equals_jax(tmp_path, rng):
    inp = str(tmp_path / "p_plumes_ext.csv")
    _plumes(rng).to_csv(inp, index=False)
    got = tcluster.cluster_plume_list(inp, str(tmp_path / "t.csv"), radius=150)
    assert got == jcluster.cluster_plume_list(inp, str(tmp_path / "j.csv"), radius=150)
    _files_equal(tmp_path / "t.csv", tmp_path / "j.csv")
    assert len(got) == 39 and len({r["Source ID"] for r in got}) <= 8


# ----------------------------------------------------------------- dedup
def test_dedup_golden_through_the_port():
    """tests/test_goldens.py::_dedup_case replayed with the port's
    functions, against the golden at its tolerance (rtol 1e-6)."""
    rng = np.random.default_rng(12345)
    n = 12
    lat = 36.0 + np.concatenate([rng.normal(0, 2e-4, 8), rng.normal(0.05, 2e-4, 4)])
    lon = -119.5 + np.concatenate([rng.normal(0, 2e-4, 8), rng.normal(0.05, 2e-4, 4)])
    flux = rng.uniform(50, 500, n)
    df = pd.DataFrame({LAT: lat, LON: lon,
                       "Source identifier": [f"S{i:03d}" for i in range(n)],
                       "Flux (kg/hr)": flux})
    overlaps = tdedup.calculate_overlap(df)
    kept = tdedup.filter_plumes(df, ["Flux (kg/hr)"])
    gold = np.load(GOLDEN)
    np.testing.assert_allclose(overlaps["V2"].to_numpy(np.float64), gold["a00"],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(np.sort(np.asarray(kept.index, np.int64)), gold["a01"])
    pd.testing.assert_frame_equal(overlaps, jdedup.calculate_overlap(df))
    pd.testing.assert_frame_equal(kept, jdedup.filter_plumes(df, ["Flux (kg/hr)"]))


def test_dedup_geometry_equals_jax(rng):
    lat, lon = rng.uniform(31, 37, 9), rng.uniform(-121, -101, 9)
    np.testing.assert_array_equal(tdedup.teale_albers(lat, lon), jdedup.teale_albers(lat, lon))
    d = np.r_[0.0, rng.uniform(0, 400, 20), 300.0]
    np.testing.assert_array_equal(tdedup.circle_overlap_fraction(d),
                                  jdedup.circle_overlap_fraction(d))
    x, y = tdedup.teale_albers(31 + rng.normal(0, 1e-3, 15), -102 + rng.normal(0, 1e-3, 15))
    np.testing.assert_array_equal(tdedup.overlap_matrix(x, y), jdedup.overlap_matrix(x, y))


@pytest.mark.parametrize("max_overlap", [0.3, 0.6, 1.0])
@pytest.mark.parametrize("facility", [False, True])
def test_remove_duplicate_plumes_equals_jax(tmp_path, rng, max_overlap, facility):
    df = _plumes(rng, n=60, nsrc=6)[:-1]
    df["Source ID"] = [f"A{i % 6:08d}" for i in range(len(df))]
    if facility:
        df["Nearest facility (best estimate)"] = rng.choice(["F1", "F2"], len(df))
    got = tdedup.remove_duplicate_plumes(df, max_overlap=max_overlap)
    pd.testing.assert_frame_equal(got, jdedup.remove_duplicate_plumes(
        df, max_overlap=max_overlap))
    assert 0 < len(got) <= len(df)


# ----------------------------------------------------------------- persistence
def test_shapefile_readers_equal_jax(shapefile):
    got = tpers.read_shapefile_polygons(shapefile)
    ref = jpers.read_shapefile_polygons(shapefile)
    assert [len(p) for p in got] == [len(p) for p in ref] == [2, 1, 2]
    for pg, pr in zip(got, ref):
        for rg, rr in zip(pg, pr):
            np.testing.assert_array_equal(rg, rr)
    dbf = shapefile[:-4] + ".dbf"
    assert tpers.read_dbf_field(dbf, "Flight_Run") == jpers.read_dbf_field(dbf, "Flight_Run")
    with pytest.raises(KeyError):
        tpers.read_dbf_field(dbf, "Name")


def test_point_in_polygon_with_holes_equals_jax(rng):
    px, py = rng.uniform(-102.7, -102.0, 200), rng.uniform(30.8, 31.5, 200)
    for rings in FLIGHTLINES:
        got = [tpers.point_in_polygon(x, y, rings) for x, y in zip(px, py)]
        assert got == [jpers.point_in_polygon(x, y, rings) for x, y in zip(px, py)]
    assert not tpers.point_in_polygon(-102.4, 31.05, FLIGHTLINES[0])      # in the hole
    assert tpers.point_in_polygon(-102.55, 31.05, FLIGHTLINES[0])


def test_source_persistence_equals_jax(shapefile, rng):
    df = _plumes(rng, n=50)[:-1]
    df["Source identifier"] = [f"S{i % 11}" for i in range(len(df))]
    df.loc[df["Source identifier"] == "S3", [LAT, LON]] = (35.0, -100.0)   # uncovered
    polys = tpers.read_shapefile_polygons(shapefile)
    names = ["fl0", "fl1", "fl2"]
    got = tpers.source_persistence(df, names, polys)
    pd.testing.assert_frame_equal(got, jpers.source_persistence(df, names, polys))
    assert got["total.overflights"].notna().any()
    assert got["source.Persistence"].isna().any()
    assert tpers.plumes_per_source([("a", 1), ("b", 2), ("a", 3)]) == \
        jpers.plumes_per_source([("a", 1), ("b", 2), ("a", 3)])


# ----------------------------------------------------------------- inversion
def _inv_case(rng, n=50, m=4):
    H = np.abs(rng.normal(size=(n, m)))
    x_true = np.array([10.0, 0.0, 5.0, 2.0])
    return H, H @ x_true + 1860.0, np.zeros(m), np.eye(m) * 1e2, np.eye(n) * 1e-2


def _close(got, ref):
    got = got.cpu().numpy()
    assert got.dtype == np.float32 and np.asarray(ref).dtype == np.float32
    assert np.abs(got - ref).max() <= INV_TOL * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inversion_equals_jax(rng, dtype):
    """The cases of tests/test_flow.py::test_inversion, with float64 and
    float32 inputs: the port returns float32 as JAX does."""
    H, y, x_a, S_a, S_o = (a.astype(dtype) for a in _inv_case(rng))
    _close(tinv.ols_inversion(H, y, device="cpu"), np.asarray(jinv.ols_inversion(H, y)))
    got = tinv.bayesian_inversion(H, y - 1860.0, x_a, S_a, S_o, device="cpu")
    _close(got, np.asarray(jinv.bayesian_inversion(H, y - 1860.0, x_a, S_a, S_o)))
    np.testing.assert_allclose(got.numpy(), [10.0, 0.0, 5.0, 2.0], atol=0.1)
    _close(tinv.posterior_covariance(H, S_a, S_o, device="cpu"),
           np.asarray(jinv.posterior_covariance(H, S_a, S_o)))
    # the float64 solve the card's check compares against
    x64 = tinv.bayesian_inversion(H, y - 1860.0, x_a, S_a, S_o, device="cpu",
                                  dtype=torch.float64)
    assert x64.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), x64.numpy(), atol=1e-3)


def test_inversion_not_positive_definite_gives_nan_as_jax(rng):
    H, y, x_a, S_a, S_o = _inv_case(rng)
    bad = -1e6 * S_o
    got = tinv.bayesian_inversion(H, y, x_a, S_a, bad, device="cpu")
    assert torch.isnan(got).all()
    assert np.isnan(np.asarray(jinv.bayesian_inversion(H, y, x_a, S_a, bad))).all()
    got = tinv.posterior_covariance(H, S_a, np.zeros_like(S_o), device="cpu")
    assert torch.isnan(got).all()
    assert np.isnan(np.asarray(jinv.posterior_covariance(H, S_a, np.zeros_like(S_o)))).all()
    # the ridge keeps empty columns solvable in both
    np.testing.assert_array_equal(tinv.ols_inversion(np.zeros((5, 4)), np.ones(5),
                                                     device="cpu").numpy(),
                                  np.asarray(jinv.ols_inversion(np.zeros((5, 4)), np.ones(5))))


def test_background_percentile_equals_jax(rng):
    v = np.r_[rng.normal(1870, 5, 30), np.nan]
    t = np.append(rng.choice(["t1", "t2", "t3"], 30), "t4")
    got = tinv.background_percentile(v, t, q=5.0)
    ref = jinv.background_percentile(v, t, q=5.0)
    assert list(got) == list(ref)
    np.testing.assert_array_equal(list(got.values()), list(ref.values()))


# ----------------------------------------------------------------- wind export
def _nc3(path):
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as nc:
        return ({k: v.data.copy() for k, v in nc.variables.items()},
                {k: {a: getattr(v, a) for a in v._attributes} for k, v in nc.variables.items()},
                dict(nc._attributes))


def _nc_values(path):
    """The variables of a NetCDF-4 (HDF5) or NetCDF-3 file."""
    with open(path, "rb") as f:
        if f.read(4) != b"\x89HDF":
            return _nc3(path)[0]
    import h5py
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def _producer_free(attrs, producer):
    """Global attributes with the producer's name masked (the port writes
    srcfinder_torch where the JAX package writes srcfinder_tpu)."""
    return {k: (v.replace(producer.encode(), b"PRODUCER") if isinstance(v, bytes)
                else v.replace(producer, "PRODUCER") if isinstance(v, str) else v)
            for k, v in attrs.items()}


@pytest.mark.parametrize("alt", [10, 80])
def test_wind_export_classic_equals_jax(tmp_path, rng, alt):
    g = make_grid(rng, ny=12, nx=16)
    p = write_grid(tmp_path, "hrrr.2020092421.wrfsfcf00.npz", g, alt=alt)
    for mod, name in ((texport, "t.nc"), (jexport, "j.nc")):
        assert mod.main(["-i", p, "-o", str(tmp_path / name), "--engine", "classic",
                         "--alt", str(alt)]) == 0
    tv, tva, tg = _nc3(str(tmp_path / "t.nc"))
    jv, jva, jg = _nc3(str(tmp_path / "j.nc"))
    assert list(tv) == list(jv)
    for k in tv:
        np.testing.assert_array_equal(tv[k], jv[k])
    assert tva == jva
    assert tg["source"] == b"srcfinder_torch" and jg["source"] == b"srcfinder_tpu"
    tg2 = {k: v for k, v in tg.items() if k != "id"}
    jg2 = {k: v for k, v in jg.items() if k != "id"}
    assert _producer_free(tg2, "srcfinder_torch") == _producer_free(jg2, "srcfinder_tpu")
    lats, lons, bands = texport.regrid_to_latlon(g)
    ref = jexport.regrid_to_latlon(g)
    np.testing.assert_array_equal(lats, ref[0])
    np.testing.assert_array_equal(lons, ref[1])
    for k in bands:
        np.testing.assert_array_equal(bands[k], ref[2][k])


def test_wind_export_netcdf4_equals_jax(tmp_path, rng):
    h5py = pytest.importorskip("h5py")
    g = make_grid(rng, ny=12, nx=16)
    p = write_grid(tmp_path, "w.npz", g)
    assert texport.wind_grid_to_nc(p, str(tmp_path / "t.nc")) == str(tmp_path / "t.nc")
    jexport.wind_grid_to_nc(p, str(tmp_path / "j.nc"))
    with h5py.File(tmp_path / "t.nc", "r") as t, h5py.File(tmp_path / "j.nc", "r") as j:
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
            assert t[k].compression == j[k].compression == "gzip"
            assert ({a: np.asarray(v).tolist() for a, v in t[k].attrs.items()
                     if a not in ("DIMENSION_LIST", "REFERENCE_LIST")}
                    == {a: np.asarray(v).tolist() for a, v in j[k].attrs.items()
                        if a not in ("DIMENSION_LIST", "REFERENCE_LIST")})
        tg = {k: v for k, v in t.attrs.items() if k != "id"}
        jg = {k: v for k, v in j.attrs.items() if k != "id"}
        assert _producer_free(tg, "srcfinder_torch") == _producer_free(jg, "srcfinder_tpu")
        assert t.attrs["source"] == "srcfinder_torch"


@pytest.mark.parametrize("name", ["hrrr.2020092421.wrfsfcf00.grib2",
                                  "rtma2p5_ru.202009242115z.2dvaranl_ndfd.grib2",
                                  "dir/hrrr.2021010100.wrfsfcf00.npz", "nope.grib2"])
def test_wind_filenames_equal_jax(name):
    assert texport.default_nc_name(name) == jexport.default_nc_name(name)
    if name == "nope.grib2":
        with pytest.raises(ValueError):
            texport.parse_wind_filename_date(name)
    else:
        assert (texport.parse_wind_filename_date(name)
                == jexport.parse_wind_filename_date(name))


# ----------------------------------------------------------------- harvester
NOW = dt.datetime(2020, 10, 1, 12, tzinfo=dt.timezone.utc)


@pytest.mark.parametrize("args", [
    {}, {"start_date": "20200924"}, {"end_date": "20200925"},
    {"start_date": "20200924", "end_date": "20200926"}, {"num_days": 3},
    {"start_date": "20200924", "num_days": 2}, {"end_date": "20200925", "num_days": 2},
    {"start_date": "20201005"}, {"start_date": "20200925", "end_date": "20200924"},
    {"num_days": 0}, {"start_date": "20200920", "end_date": "20200921", "num_days": 1}])
def test_set_date_range_equals_jax(args):
    try:
        ref = jharvester.set_date_range(args, now=NOW)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tharvester.set_date_range(args, now=NOW)
        return
    assert tharvester.set_date_range(args, now=NOW) == ref


def test_harvester_helpers_equal_jax():
    conf = {"url_template": "http://example.com/%Y%m%d/f_%H%M%S.grib2",
            "local_path_template": "%Y%m%d/f_%H.grib2", "time_res": "90m"}
    s, e = tharvester.set_date_range({"start_date": "20200924", "num_days": 1}, now=NOW)
    assert (list(tharvester.paths_generator(s, e, "/b", conf))
            == list(jharvester.paths_generator(s, e, "/b", conf)))
    for res in ("90s", "3h", "1d", "2w", "15m"):
        assert tharvester.time_setting_dict(res) == jharvester.time_setting_dict(res)
    day = dt.date(2020, 9, 24)
    assert (tharvester.invoke_harvester_windows(day)
            == jharvester.invoke_harvester_windows(day))


def test_harvest_cli_file_urls_equal_jax(tmp_path):
    """``srcfinder-harvest`` over file:// templates: the same granules
    fetched, an idempotent rerun, and a missing granule counted failed."""
    src = tmp_path / "remote"
    os.makedirs(src)
    for h in range(0, 24, 6):
        if h != 12:
            (src / f"file_{h:02d}.grib2").write_text(str(h))
    conf = tmp_path / "ds.yaml"
    conf.write_text(f"url_template: file://{src}/file_%H.grib2\n"
                    "local_path_template: '%Y%m%d/file_%H.grib2'\n"
                    "time_res: '6h'\n")
    argv = ["-c", str(conf), "-s", "20200924", "-n", "1"]
    for tag, mod in (("port", tharvester), ("jax", jharvester)):
        assert mod.main(argv + ["-b", str(tmp_path / tag)]) == 1   # 12 h is missing
        (src / "file_12.grib2").write_text("12")
        assert mod.main(argv + ["-b", str(tmp_path / tag)]) == 0
        os.remove(src / "file_12.grib2")
    assert (sorted(os.listdir(tmp_path / "port" / "20200924"))
            == sorted(os.listdir(tmp_path / "jax" / "20200924"))
            == ["file_00.grib2", "file_06.grib2", "file_12.grib2", "file_18.grib2"])


def test_wind_quality_check_equals_jax(tmp_path, rng):
    ok = write_grid(tmp_path, "ok.npz", make_grid(rng))
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a npz")
    for path in (ok, str(bad)):
        alerts = {"port": [], "jax": []}
        got = tharvester.wind_quality_check(path, alert=lambda s, m: alerts["port"].append((s, m)))
        ref = jharvester.wind_quality_check(path, alert=lambda s, m: alerts["jax"].append((s, m)))
        assert got == ref and alerts["port"] == alerts["jax"]
        assert got == (path == ok)


# ----------------------------------------------------------------- utils
def test_concat_csvs_equals_jax(tmp_path, rng):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"c{i}.csv")
        pd.DataFrame(rng.normal(size=(4, 3)), columns=list("abc")).to_csv(p, index=False)
        paths.append(p)
    assert tutils.concat_csvs(paths, str(tmp_path / "t.csv")) == str(tmp_path / "t.csv")
    jutils.concat_csvs(paths, str(tmp_path / "j.csv"))
    _files_equal(tmp_path / "t.csv", tmp_path / "j.csv")
    assert len(pd.read_csv(tmp_path / "t.csv")) == 12


def test_run_r_script_without_r_raises_as_jax(tmp_path):
    for mod in (tutils, jutils):
        with pytest.raises(FileNotFoundError):
            mod.run_r_script(str(tmp_path / "s.R"), ["a"], rscript="no-such-Rscript-binary")


def test_run_r_script_equals_jax(tmp_path):
    if shutil.which("Rscript") is None:
        pytest.skip("Rscript is not installed")
    script = tmp_path / "s.R"
    script.write_text("args <- commandArgs(TRUE); cat(args, sep=',')\n")
    got = tutils.run_r_script(str(script), [1, "b"])
    assert got.stdout == jutils.run_r_script(str(script), [1, "b"]).stdout == "1,b"


# ----------------------------------------------------------------- job runner
WORKER_JOBS = ("cluster-incr-nn", "filter-plumes", "source-persistence",
               "inversion-run", "wind-quality-check", "wind-bands-nc")


def test_render_command_equals_jax():
    specs = tdeploy.load_job_specs(JOBS_JSON)
    assert specs == jdeploy.load_job_specs(JOBS_JSON)
    params = {k: f"/v/{k}" for spec in specs.values()
              for k in tdeploy.command_placeholders(spec)}
    for name, spec in specs.items():
        assert tdeploy.command_placeholders(spec) == jdeploy.command_placeholders(spec)
        assert (tdeploy.render_command(spec, params)
                == jdeploy.render_command(spec, params)), name
        with pytest.raises(KeyError):
            tdeploy.render_command({"command": ["x", "{NOPE}"]}, {})


def _event_dir(d):
    os.makedirs(d)
    for name in ("perm_plumes_ext.csv", "perm_plumes_cluster.csv", "trop_meta.csv",
                 "hrrr.2020092421.wrfsfcf00.npz", "README.txt", "x_cmf_v2_img"):
        (d / name).write_text("x")
    return d


@pytest.mark.parametrize("explicit", [WORKER_JOBS, (), ("compute-ime", "inversion-run")])
def test_run_jobs_argv_equals_jax(tmp_path, explicit):
    """The deployment's job map over one event directory: the same jobs
    submitted with the same rendered argv as the JAX package's runner."""
    specs = tdeploy.load_job_specs(JOBS_JSON)
    extra = {"OUTFILE": "out", "FLIGHTLINES": "fl.shp", "WEIGHTS": "w.npz",
             "LIBRARY": "lib.txt"}
    ran = {"port": [], "jax": []}
    for tag, mod in (("port", tdeploy), ("jax", jdeploy)):
        d = _event_dir(tmp_path / tag)
        q, jobs = mod.run_jobs(specs, str(d), extra_params=extra, once=True, force=True,
                               runner=ran[tag].append, explicit_jobs=set(explicit))
        assert not q.failures
    strip = [[a.replace(str(tmp_path / t), "D") for a in argv]
             for t in ("port", "jax") for argv in ran[t]]
    assert strip[:len(ran["port"])] == strip[len(ran["port"]):]
    names = {argv[0] for argv in ran["port"]}
    if explicit == WORKER_JOBS:
        assert names == {"srcfinder-cluster", "srcfinder-dedup", "srcfinder-persistence",
                         "srcfinder-inversion", "srcfinder-wind-qc", "srcfinder-wind-nc"}
    elif explicit == ():
        assert names == set()
    else:
        assert names == {"srcfinder-ime", "srcfinder-inversion"}


def test_port_argv_maps_console_scripts_to_the_dispatcher():
    argv = tdeploy.port_argv(["srcfinder-inversion", "/g/trop_meta.csv"])
    assert argv == [sys.executable, "-m", "srcfinder_torch", "inversion", "/g/trop_meta.csv"]
    assert tdeploy.port_argv(["python", "-c", "pass"]) == ["python", "-c", "pass"]
    for name in ("srcfinder-", "srcfinder-nope"):
        with pytest.raises(ValueError, match=name):
            tdeploy.port_argv([name])


@pytest.mark.parametrize("name", ["tagger", "collect-qc", "covid-oracle"])
def test_port_argv_maps_the_qc_and_triage_scripts(name):
    """The QC and triage scripts run through the dispatcher like the rest."""
    argv = tdeploy.port_argv([f"srcfinder-{name}", "--help"])
    assert argv == [sys.executable, "-m", "srcfinder_torch", name, "--help"]


def test_default_runner_fails_unknown_scripts_in_the_queue(tmp_path):
    """A job whose script the port does not run fails with its message in
    the queue's failures and starts no process; a known one runs through
    ``python -m srcfinder_torch``."""
    d = tmp_path / "in"
    os.makedirs(d)
    (d / "a.dat").write_text("1")
    specs = {name: {"command": [script, "{path}"],
                    "trigger": {"regex": r".*\.dat$", "param": "path"}}
             for name, script in (("tag", "srcfinder-"), ("nope", "srcfinder-nope"),
                                  ("qc", "srcfinder-wind-qc"))}
    specs["qc"]["command"] = ["srcfinder-wind-qc", "-f", "{path}"]
    q, jobs = tdeploy.run_jobs(specs, str(d), once=True, force=True)
    assert len(jobs) == 3 and not q.results
    msgs = {job.job_type: str(err) for job, err in q.failures}
    assert "not a console script" in msgs["tag"]
    assert "srcfinder-nope" in msgs["nope"]
    assert isinstance(dict((j.job_type, e) for j, e in q.failures)["qc"],
                      subprocess.CalledProcessError)            # a.dat is no wind grid


def test_job_queue_workers_equal_jax():
    for mod in (tdeploy, jdeploy):
        q = mod.JobQueue(workers=3)
        q.register("sq", lambda p: p["v"] ** 2)
        q.register("fail", lambda p: 1 / 0)
        for v in range(20):
            q.submit(mod.Job("sq", {"v": v}))
        q.submit(mod.Job("fail", {}))
        q.join()
        q.shutdown()
        assert sorted(r for _, r in q.results) == [v * v for v in range(20)]
        assert len(q.failures) == 1


def test_jobs_cli_equals_jax(tmp_path):
    spec = {"echo": {"command": [sys.executable, "-c", "import sys; sys.exit(0)", "{path}"],
                     "trigger": {"regex": r".*\.dat$", "param": "path"}},
            "other": {"command": ["x", "{path}", "{MISSING}"],
                      "trigger": {"regex": r".*\.zz$", "param": "path", "opt_in": True}}}
    sf = tmp_path / "jobs.json"
    sf.write_text(json.dumps(spec))
    for tag, mod in (("port", tdeploy), ("jax", jdeploy)):
        d = tmp_path / tag
        os.makedirs(d)
        (d / "a.dat").write_text("1")
        assert mod.main([str(sf), "--watch", str(d), "--once", "--force"]) == 0
        assert mod.main([str(sf), "--watch", str(d), "--once", "--jobs", "other"]) == 2


# ----------------------------------------------------------------- stage mains
def _run_port(argv):
    """The CPU test runner of a rendered job command: the dispatcher's main
    in this process, with --device cpu for the mains that take it."""
    name = tdeploy.port_argv(argv)[3]
    extra = ["--device", "cpu"] if name in ("inversion", "windspeed") else []
    rc = tmain.main([name, *argv[1:], *extra])
    if rc:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return rc


def _run_jax(argv):
    fn = {"srcfinder-cluster": jclis.cluster_main, "srcfinder-dedup": jclis.dedup_main,
          "srcfinder-persistence": jclis.persistence_main,
          "srcfinder-inversion": jclis.inversion_main,
          "srcfinder-wind-qc": jclis.wind_qc_main, "srcfinder-wind-nc": jexport.main}
    rc = fn[argv[0]](list(argv[1:]))
    if rc:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return rc


def _grid_dir(d, rng, n=6, m=40):
    os.makedirs(d)
    pd.DataFrame({"lat": [31.0, 31.25]}).to_csv(d / "lat.csv", index=False)
    pd.DataFrame({"lon": [-102.5, -102.2, -101.9]}).to_csv(d / "lon.csv", index=False)
    H = np.round(np.abs(rng.normal(0.3, 0.2, (m, n))), 4)
    np.savetxt(d / "trop_H.csv", H, delimiter=",")
    y = H @ rng.uniform(5, 15, n) + rng.normal(0, 0.2, m)
    pd.DataFrame({"xch4": np.round(1870 + y, 3), "back": 1870.0}).to_csv(
        d / "trop_meta.csv", index=False)


def test_deployment_job_chain_on_the_cpu_equals_jax(tmp_path, rng):
    """The cluster -> dedup -> persistence chain, the inversion, the wind
    QC and the wind NetCDF through deployment/jobs.json and the port's
    dispatcher (in-process, --device cpu), stage by stage: each watched
    directory holds the stage's input, each stage's OUTFILE feeds the
    next. Every file equals the JAX mains' on the same inputs (the
    inversion's within INV_TOL, the NetCDF's values and attributes)."""
    specs = tdeploy.load_job_specs(JOBS_JSON)
    plumes = _plumes(rng, n=60)
    shp = str(tmp_path / "fl.shp")
    _write_shp(shp, FLIGHTLINES)
    _write_dbf(tmp_path / "fl.dbf", "Flight_Run", ["l1", "l2", "l3"])
    g = make_grid(rng, ny=12, nx=16)
    out = {}
    for tag, runner in (("port", _run_port), ("jax", _run_jax)):
        root = tmp_path / tag
        stages = [root / f"s{i}" for i in range(4)]
        for s in stages:
            os.makedirs(s)
        plumes.to_csv(stages[0] / "perm_plumes_ext.csv", index=False)
        _grid_dir(stages[0] / "trop", np.random.default_rng(5))
        write_grid(stages[0], "hrrr.2020092421.wrfsfcf00.npz", g)
        write_grid(stages[3], "hrrr.2020092421.wrfsfcf00.npz", g)
        plan = [(stages[0], ["cluster-incr-nn", "inversion-run", "wind-quality-check"],
                 {"OUTFILE": str(stages[1] / "perm_plumes_cluster.csv")}),
                (stages[1], ["filter-plumes"],
                 {"OUTFILE": str(stages[2] / "perm_plumes_dedup.csv")}),
                (stages[2], ["source-persistence"],
                 {"FLIGHTLINES": shp, "OUTFILE": str(root / "persistence.csv")}),
                (stages[3], ["wind-bands-nc"], {"OUTFILE": str(root / "winds.nc")})]
        names = []
        for watch, jobs, extra in plan:
            q, submitted = tdeploy.run_jobs({k: specs[k] for k in jobs}, str(watch),
                                            extra_params=extra, once=True, force=True,
                                            runner=runner, explicit_jobs=set(jobs))
            assert not q.failures, q.failures
            names += sorted(j.job_type for j in submitted)
        assert names == ["cluster-incr-nn", "inversion-run", "wind-quality-check",
                         "filter-plumes", "source-persistence", "wind-bands-nc"]
        out[tag] = root
    for rel in ("s1/perm_plumes_cluster.csv", "s2/perm_plumes_dedup.csv",
                "persistence.csv"):
        _files_equal(out["port"] / rel, out["jax"] / rel)
    assert len(pd.read_csv(out["port"] / "persistence.csv")) > 0
    for rel in ("s0/trop/x_hat.csv", "s0/trop/S_hat.csv"):
        got = np.loadtxt(out["port"] / rel, delimiter=",").astype(np.float32)
        ref = np.loadtxt(out["jax"] / rel, delimiter=",").astype(np.float32)
        assert np.abs(got - ref).max() <= INV_TOL * np.abs(ref).max()
    tv, jv = (_nc_values(str(out[t] / "winds.nc")) for t in ("port", "jax"))
    assert list(tv) == list(jv) and all(np.array_equal(tv[k], jv[k]) for k in jv)


def test_cluster_and_dedup_mains_equal_jax(tmp_path, rng):
    p = str(tmp_path / "p.csv")
    _plumes(rng).to_csv(p, index=False)
    for tag, mod in (("t", tclis), ("j", jclis)):
        assert mod.cluster_main([p, str(tmp_path / f"{tag}_c.csv"), "-r", "150", "-v"]) == 0
        df = pd.read_csv(tmp_path / f"{tag}_c.csv")
        df["Line name"] = df["Line name"].astype(str)
        df.to_csv(tmp_path / f"{tag}_c2.csv", index=False)
        for mo in ([], ["--max_overlap", "0.5"]):
            assert mod.dedup_main([str(tmp_path / f"{tag}_c2.csv"),
                                   str(tmp_path / f"{tag}_d{len(mo)}.csv"), *mo]) == 0
    _files_equal(tmp_path / "t_c.csv", tmp_path / "j_c.csv")
    assert os.path.getsize(tmp_path / "t_c.csv.pdf") > 0
    for k in (0, 2):
        _files_equal(tmp_path / f"t_d{k}.csv", tmp_path / f"j_d{k}.csv")


@pytest.mark.parametrize("names", ["Flight_Run", "Name", None])
def test_persistence_main_equals_jax(tmp_path, rng, names):
    shp = str(tmp_path / "fl.shp")
    _write_shp(shp, FLIGHTLINES)
    if names == "Flight_Run":
        _write_dbf(tmp_path / "fl.dbf", "Flight_Run", ["a", "b", "c"])
    elif names == "Name":
        _write_dbf(tmp_path / "fl.dbf", "Name", ["a x", "b y", "c z"])
    df = _plumes(rng)[:-1]
    df["Source ID"] = [f"A{i % 7:08d}" for i in range(len(df))]
    df.to_csv(tmp_path / "s.csv", index=False)
    for tag, mod in (("t", tclis), ("j", jclis)):
        assert mod.persistence_main([str(tmp_path / "s.csv"), shp,
                                     str(tmp_path / f"{tag}.csv")]) == 0
    _files_equal(tmp_path / "t.csv", tmp_path / "j.csv")


def test_inversion_main_equals_jax_and_the_functions(tmp_path, rng):
    """The CLI's x_hat/S_hat beside those of the JAX CLI (INV_TOL) and, bit
    for bit, beside a direct call of the port's functions on its inputs;
    --plot writes the figure; the trop_meta.csv path stands for its
    directory."""
    for tag in ("t", "j"):
        _grid_dir(tmp_path / tag, np.random.default_rng(11))
    assert tclis.inversion_main([str(tmp_path / "t"), "--plot", "--device", "cpu"]) == 0
    assert jclis.inversion_main([str(tmp_path / "j" / "trop_meta.csv")]) == 0
    assert (tmp_path / "t" / "x_hat.png").is_file()
    for name in ("x_hat.csv", "S_hat.csv"):
        got = np.loadtxt(tmp_path / "t" / name, delimiter=",").astype(np.float32)
        ref = np.loadtxt(tmp_path / "j" / name, delimiter=",").astype(np.float32)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= INV_TOL * np.abs(ref).max()
    H = pd.read_csv(tmp_path / "t" / "trop_H.csv", header=None).values.astype(np.float32)
    meta = pd.read_csv(tmp_path / "t" / "trop_meta.csv")
    y = (meta["xch4"] - meta["back"]).values.astype(np.float32)
    x_a = np.full(H.shape[1], 10.0, np.float32)
    x = tinv.bayesian_inversion(H, y, x_a, np.diag((0.5 * x_a) ** 2),
                                np.diag((0.1 * y) ** 2), device="cpu").numpy()
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "t" / "x_hat.csv", delimiter=",").astype(np.float32), x)
    if not torch.cuda.is_available():          # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tclis.inversion_main([str(tmp_path / "t")])


def _stations(url):
    return {"STATION": [{"LONGITUDE": "-119.6", "LATITUDE": "36.0",
                         "OBSERVATIONS": {"wind_speed_set_1": [2.0, None, 4.0]}}]}


def test_wind_mains_equal_jax(tmp_path, monkeypatch):
    """windspeed (the port's nearest cells on --device cpu), station-winds
    (a fake Mesowest fetch in both packages) and wind-qc: the same files
    and exit codes as the JAX mains."""
    winds = str(tmp_path / "winds")
    files = write_winds_dir(winds)
    rows = [("ang20200924t211102-1", 36.0431, -119.5123, 0.0312, 0.0041, 0.52),
            ("ang20200924t211102-2", 36.0377, -119.5290, 0.0108, 0.0, 0.91)]
    for _, lat, lon, *_ in rows:
        assert_jax_selection_is_oracle((lon, lat), files)
    pcsv = tmp_path / "ang_plumes_minppmm500.csv"
    with open(pcsv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Candidate ID", LAT, LON, "AvgIMEdivFetch20 (kg/m)",
                    "StdIMEdivFetch20 (kg/m)", "Aspect ratio20"])
        w.writerows(rows)
    monkeypatch.setattr(tstations, "_urllib_fetch", _stations)
    monkeypatch.setattr(jstations, "_urllib_fetch", _stations)
    for tag, mod, extra in (("t", tclis, ["--device", "cpu"]), ("j", jclis, [])):
        assert mod.windspeed_main(["-p", str(tmp_path / "*plumes*.csv"), "-w",
                                   os.path.join(winds, "hrrr"), "--wind-ext", ".npz",
                                   "-o", str(tmp_path / f"{tag}_w.csv")] + extra) == 0
        assert mod.station_winds_main([str(pcsv), str(tmp_path / f"{tag}_s.csv"),
                                       "token"]) == 0
        assert mod.wind_qc_main(["-f", files[0]]) == 0
        assert mod.wind_qc_main(["-f", str(pcsv)]) == 1
    _files_equal(tmp_path / "t_w.csv", tmp_path / "j_w.csv")
    _files_equal(tmp_path / "t_s.csv", tmp_path / "j_s.csv")
    got = pd.read_csv(tmp_path / "t_w.csv")
    assert (got["Emission Rate (kg/hr) [HRRR 10 m]"] > 0).all()
    assert (pd.read_csv(tmp_path / "t_s.csv")["Station wind speed (m/s)"] == 3.0).all()


# ----------------------------------------------------------------- dispatcher
@pytest.mark.parametrize("name", sorted(tmain.COMMANDS))
def test_dispatcher_names_resolve(name):
    """Each of the 25 console scripts resolves to a callable main of
    the port, for a name of the JAX package's pyproject.toml."""
    module, func = tmain.COMMANDS[name].split(":")
    assert module.startswith("srcfinder_torch.")
    assert callable(getattr(importlib.import_module(module), func))


def test_dispatcher_covers_the_console_scripts():
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        scripts = [line.split("=")[0].strip() for line in f
                   if line.startswith("srcfinder-")]
    assert len(scripts) == 25
    names = {s[len("srcfinder-"):] for s in scripts}
    assert names == set(tmain.COMMANDS)
    assert len(tmain.COMMANDS) == 25


@pytest.mark.parametrize("argv,expect", [([], "names:"), (["srcfinder-cmf"], "unknown command"),
                                         (["nope"], "unknown command")])
def test_dispatcher_exits_2_without_the_jax_package(argv, expect):
    """No name, a console script's full name, an unknown name: exit 2, a message,
    and no import of jax or srcfinder_tpu (every import, traced)."""
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1")
    out = subprocess.run([sys.executable, "-m", "srcfinder_torch", *argv], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert expect in out.stderr
    imported = [line.split("|")[-1].strip() for line in out.stderr.splitlines()
                if line.startswith("import time:")]
    assert imported and not [m for m in imported
                             if m.split(".")[0] in ("jax", "jaxlib", "flax", "srcfinder_tpu")]


def test_dispatcher_runs_a_main(tmp_path, rng, capsys):
    g = make_grid(rng)
    p = write_grid(tmp_path, "ok.npz", g)
    assert tmain.main(["wind-qc", "-f", p]) == 0
    assert "OK" in capsys.readouterr().out
    assert tmain.main(["wind-nc", "-i", p, "-o", str(tmp_path / "o.nc"),
                       "--engine", "classic"]) == 0
    assert os.path.isfile(tmp_path / "o.nc")
