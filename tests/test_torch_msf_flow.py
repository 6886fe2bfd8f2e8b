"""The port's msf-flow stage and the command lines around it
(srcfinder_torch.flow.msf_flow, .ime_worker, .stations, .objectstore,
.grib_cli, detect.salience_cli, masks.cli --store-in/--store-out) held
against the JAX package's on the CPU.

The wind grids are the coarse ones of tests/test_torch_winds.py, on which
the JAX package's float32 nearest-cell selection is the float64 oracle's
(asserted first), so the enriched rows equal the JAX package's: strings
exactly, numbers at rtol 1e-12, and the CSV files the two write byte for
byte. The IME merge, the CLIs' CSV and npz products and the masks are
compared exactly.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from srcfinder_tpu.core import envi as jenvi
from srcfinder_tpu.core.xlsx import read_xlsx_rows as jread_xlsx_rows
from srcfinder_tpu.detect import salience_cli as jsalience_cli
from srcfinder_tpu.flow import grib_cli as jgrib_cli
from srcfinder_tpu.flow import ime_worker as jime
from srcfinder_tpu.flow import msf_flow as jmsf
from srcfinder_tpu.flow import stations as jstations
from srcfinder_tpu.masks import cli as jmasks_cli
from srcfinder_torch.core.envi import open_envi
from srcfinder_torch.core.xlsx import read_xlsx_rows, write_xlsx
from srcfinder_torch.detect import salience_cli as tsalience_cli
from srcfinder_torch.flow import grib_cli as tgrib_cli
from srcfinder_torch.flow import ime_worker as time_
from srcfinder_torch.flow import msf_flow as tmsf
from srcfinder_torch.flow import stations as tstations
from srcfinder_torch.flow.objectstore import LocalObjectStore
from srcfinder_torch.masks import cli as tmasks_cli
from tests.test_flow import _encode_grib2_complex, _tenths_grid
from tests.test_torch_masks import _radiance
from tests.test_torch_winds import assert_jax_selection_is_oracle, write_winds_dir

torch.set_num_threads(1)

HEADER = ["Candidate ID", "Line name", "Plume Latitude (deg)", "Plume Longitude (deg)",
          "CMF Max (ppmm)", "AvgIMEdivFetch20 (kg/m)", "StdIMEdivFetch20 (kg/m)",
          "Aspect ratio20"]
# candidates of one flightline near the scene's plume (36.04 N, 119.5 W),
# listed out of order; the second has no IME match, the fourth an aspect
# ratio out of [0.02, 1]
ROWS = [["ang20200924t211102-3", "ang20200924t211102", 36.0512, -119.4871, 812.5,
         0.0312, 0.0041, 0.52],
        ["ang20200924t211102-1", "ang20200924t211102", 36.0431, -119.5123, 1533.25,
         "", "", ""],
        ["ang20200924t211102-2", "ang20200924t211102", 36.0377, -119.5290, 402.0,
         0.0108, 0.0, 0.91],
        ["ang20200924t211102-4", "ang20200924t211102", 36.0290, -119.5011, 950.0,
         0.0205, 0.0033, 0.011]]


@pytest.fixture(scope="module")
def winds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("winds"))
    files = write_winds_dir(root)
    for row in ROWS:
        assert_jax_selection_is_oracle((row[3], row[2]), files)
    return root


def _plume_list(d, ext=".csv", rows=ROWS, name="ang20200924t211102_plumes_minppmm500"):
    path = os.path.join(str(d), name + ext)
    if ext == ".xlsx":
        write_xlsx(path, [HEADER] + [[None if v == "" else v for v in r] for r in rows])
    else:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(HEADER)
            w.writerows(rows)
    return path


def _assert_rows_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            if isinstance(r[k], str):
                assert g[k] == r[k], k
            else:
                np.testing.assert_allclose(g[k], r[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("ext", [".csv", ".xlsx"])
def test_process_plumes_equals_jax(tmp_path, winds, ext):
    """Every candidate enriched with HRRR 10 m, HRRR 80 m and RTMA 10 m
    statistics and emission rates, sorted by the first field; with two
    threads the rows equal the one-thread run's exactly."""
    flist = [_plume_list(tmp_path, ext)]
    ref = jmsf.process_plumes(flist, winds, ext=".npz")
    one = tmsf.process_plumes(flist, winds, ext=".npz", device="cpu")
    two = tmsf.process_plumes(flist, winds, nprocs=2, ext=".npz", device="cpu")
    _assert_rows_equal(one, ref)
    assert two == one
    assert [p["Candidate ID"] for p in one] == sorted(r[0] for r in ROWS)
    keys = list(one[0])
    assert sum("Wind Mean" in k for k in keys) == 3
    assert "Emission Rate (kg/hr) [HRRR 10 m]" in keys
    assert "Emission Rate (kg/hr) [RTMA 10 m]" in keys
    assert one[0]["Emission Rate (kg/hr) [HRRR 10 m]"] == "NA"       # no IME
    assert one[3]["Aspect Ratio Flag (0=valid, 1=invalid)"] == 1
    mean = one[2]["Wind Mean (m/s) [RTMA 10 m, 10 nearest points for each of 3 "
                  "closest times]"]
    assert one[2]["Emission Rate (kg/hr) [RTMA 10 m]"] == pytest.approx(
        0.0312 * mean * 3600, rel=1e-12)
    if ext == ".xlsx":
        assert read_xlsx_rows(flist[0]) == jread_xlsx_rows(flist[0])


def test_insert_plumes_in_file_equals_jax(tmp_path, winds):
    """Appending to an existing merged list: the .bak backup, the rows
    sorted by Candidate ID after the old ones, the columns in the first
    row's order; the port's file equals the JAX package's byte for byte."""
    first = tmsf.process_plumes([_plume_list(tmp_path, rows=ROWS[:2])], winds,
                                ext=".npz", device="cpu")
    more = [_plume_list(tmp_path, rows=ROWS[2:], name="later_minppmm250")]
    outs = {}
    for tag, mod, kw in (("port", tmsf, {"device": "cpu"}), ("jax", jmsf, {})):
        out = str(tmp_path / tag / "merged.csv")
        mod.insert_plumes_in_file([dict(p) for p in first], out)
        original = open(out).read()
        mod.insert_plumes_in_file(mod.process_plumes(more, winds, ext=".npz", **kw), out,
                                  sort_by_key="Candidate ID")
        assert open(out + ".bak").read() == original
        outs[tag] = open(out).read()
        mod.insert_plumes_in_file([], out)                    # no plumes: untouched
        assert open(out).read() == outs[tag]
    assert outs["port"] == outs["jax"]
    rows = list(csv.DictReader(outs["port"].splitlines()))
    assert [r["Candidate ID"] for r in rows] == sorted(r[0] for r in ROWS)
    assert [r["Minimum Threshold (ppmm)"] for r in rows] == ["500", "250", "500", "250"]


def test_msf_flow_cli_equals_jax(tmp_path, winds):
    """The CLI from an object store (a local one: plume lists fetched by
    --regex, the merged output uploaded back) and from one file with two
    threads: the port's output equals the JAX package's byte for byte."""
    bucket = LocalObjectStore(str(tmp_path / "bucket"))
    bucket.put(_plume_list(tmp_path), "ang20200924t211102_plumes_minppmm500.csv")
    bucket.put(_plume_list(tmp_path, name="other"), "other.csv")  # no match
    outs = {}
    for tag, mod, extra in (("port", tmsf, ["--device", "cpu"]), ("jax", jmsf, [])):
        out = str(tmp_path / tag / "merged.csv")
        assert mod.main(["-w", winds, "-o", out, "--wind-ext", ".npz", "--store",
                         str(tmp_path / "bucket")] + extra) == 0
        assert bucket.exists("merged.csv")
        os.remove(os.path.join(str(tmp_path / "bucket"), "merged.csv"))
        one = str(tmp_path / tag / "one.csv")
        assert mod.main(["-w", winds, "-o", one, "--wind-ext", ".npz", "-n", "2",
                         "--flmode", _plume_list(tmp_path, ".xlsx")] + extra) == 0
        outs[tag] = open(out).read(), open(one).read()
    assert outs["port"] == outs["jax"]
    assert len(list(csv.DictReader(outs["port"][0].splitlines()))) == len(ROWS)
    empty = tmp_path / "empty"
    os.makedirs(empty)
    assert tmsf.main(["-w", winds, "-o", str(tmp_path / "x.csv"), "-p", str(empty),
                      "--device", "cpu"]) == 0
    assert not os.path.exists(tmp_path / "x.csv")


def _stations(url):
    return {"STATION": [
        {"LONGITUDE": "-119.6", "LATITUDE": "36.0",
         "OBSERVATIONS": {"wind_speed_set_1": [2.0, None, 4.0]}},
        {"LONGITUDE": "-120.0", "LATITUDE": "36.5",
         "OBSERVATIONS": {"wind_speed_set_1": [9.0]}},
        {"LONGITUDE": "-119.5", "LATITUDE": "36.04",
         "OBSERVATIONS": {"wind_speed_set_1": []}}]}


def _no_network(url):
    raise OSError("no network")


def test_stations_with_fake_fetch_equal_jax(tmp_path, winds):
    plumes = [{"Candidate ID": "ang20200924t211102-1",
               "Plume Latitude (deg)": "36.0431", "Plume Longitude (deg)": "-119.5123"},
              {"Candidate ID": "no-time", "Plume Latitude (deg)": "36.0",
               "Plume Longitude (deg)": "-119.5"}]
    for plume in plumes:
        for fetch in (_stations, _no_network):
            for fill in (None, "-9999"):
                got = tstations.get_station_data_for_plume(plume, fill=fill, fetch=fetch)
                assert got == jstations.get_station_data_for_plume(plume, fill=fill,
                                                                   fetch=fetch)
    got = tstations.get_station_data_for_plume(plumes[0], fetch=_stations)
    assert got["Station wind speed (m/s)"] == 3.0
    flist = [_plume_list(tmp_path)]
    _assert_rows_equal(
        tmsf.process_plumes(flist, winds, ext=".npz", station_fetch=_stations,
                            device="cpu"),
        jmsf.process_plumes(flist, winds, ext=".npz", station_fetch=_stations))


@pytest.mark.parametrize("mergedists", [(10, 20, 50), (10, 50)])
def test_merge_ime_into_plumelist_equals_jax(mergedists):
    """A 150 m haversine match; the 20 m merge distance's rows, or the
    nearest distance's when 20 m is absent."""
    rng = np.random.default_rng(3)
    ime = pd.DataFrame([dict(mergedist_m=md, plume=i, ime_div_fetch=v, aspect=a,
                             lat=36.0431 + dy, lon=-119.5123 + dx)
                        for md in mergedists
                        for i, (v, a, dy, dx) in enumerate(zip(
                            rng.uniform(0.01, 0.05, 4), rng.uniform(0.1, 1, 4),
                            [0.0, 0.0004, 0.0009, 0.3], [0.0, 0.0006, -0.0011, 0.2]))])
    ime.loc[5, "ime_div_fetch"] = np.nan
    plumes = pd.DataFrame(ROWS, columns=HEADER).drop(columns=HEADER[5:])
    plumes.loc[len(plumes)] = ["x-5", "x", "nan", "-119.5", 0.0]
    got = time_.merge_ime_into_plumelist(plumes.copy(), ime)
    ref = jime.merge_ime_into_plumelist(plumes.copy(), ime)
    pd.testing.assert_frame_equal(got, ref, check_exact=True)
    assert np.isfinite(got.loc[1, "AvgIMEdivFetch20 (kg/m)"])
    assert time_.merge_ime_into_plumelist(plumes.copy(), pd.DataFrame()).shape == (5, 8)


def test_ime_cli_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    cmf = np.zeros((48, 40, 4), np.float32)
    cmf[..., 3] = rng.normal(200.0, 150.0, (48, 40))
    cmf[10:16, 10:15, 3] = 2500.0
    cmf[30:34, 25:29, 3] = 1900.0
    cmf[0, 0] = -9999.0
    meta = {"data ignore value": -9999,
            "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1",
                         "11", "North", "WGS-84", "units=Meters", "rotation=0"]}
    path = str(tmp_path / "ang20200924t211102_cmf_v2y1_img")
    jenvi.save_envi(path + ".hdr", cmf, metadata=meta, interleave="bip")
    for tag, mod in (("port", time_), ("jax", jime)):
        mod.main([path, "-o", str(tmp_path / f"{tag}.csv"), "--mergedists", "10 20 50"])
    got = open(tmp_path / "port.csv").read()
    assert got == open(tmp_path / "jax.csv").read()
    assert len(pd.read_csv(tmp_path / "port.csv")) == 5     # one merge at 50 m


def test_grib_cli_equals_jax(tmp_path):
    g = _tenths_grid(np.random.default_rng(4))
    src = str(tmp_path / "hrrr.2020092421.wrfsfcf00.grib2")
    _encode_grib2_complex(src, g, spatial_order=2, levels=(10, 80))
    bad = str(tmp_path / "bad.grib2")
    with open(bad, "wb") as f:
        f.write(b"NOPE")
    for tag, mod in (("port", tgrib_cli), ("jax", jgrib_cli)):
        assert mod.main([src, "-o", str(tmp_path / tag), "--alts", "10", "80"]) == 0
        assert mod.main([bad, src, "-o", str(tmp_path / (tag + "2"))]) == 1
    for d in ("", "2"):
        got = np.load(tmp_path / ("port" + d) / "hrrr.2020092421.wrfsfcf00.npz")
        ref = np.load(tmp_path / ("jax" + d) / "hrrr.2020092421.wrfsfcf00.npz")
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_salience_cli_equals_jax(tmp_path):
    """Three salience regions, one without CMF enhancement: the same plume
    list (csv text) and quicklook PDF names."""
    rng = np.random.default_rng(6)
    h, w = 40, 36
    sal = rng.uniform(0.0, 0.3, (h, w, 1)).astype(np.float32)
    sal[5:12, 4:10] = 0.9
    sal[20:26, 20:30] = 0.75
    sal[32:36, 2:6] = 0.6
    cmf = np.abs(rng.normal(1.0, 0.2, (h, w, 4))).astype(np.float32)
    cmf[..., 3] = rng.normal(100.0, 50.0, (h, w))
    cmf[6:10, 5:9, 3] = 900.0
    cmf[21:25, 22:28, 3] = 600.0
    cmf[0, 0, :] = -9999.0
    meta = {"data ignore value": -9999,
            "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1",
                         "11", "North", "WGS-84", "units=Meters", "rotation=0"]}
    salf = str(tmp_path / "ang20200924t211102_cmf_v2y1_img_saliency")
    cmff = str(tmp_path / "ang20200924t211102_cmf_v2y1_img")
    jenvi.save_envi(salf + ".hdr", sal, metadata=meta, interleave="bip")
    jenvi.save_envi(cmff + ".hdr", cmf, metadata=meta, interleave="bip")
    outs = {}
    for tag, mod in (("port", tsalience_cli), ("jax", jsalience_cli)):
        assert mod.main([salf, cmff, "--outdir", str(tmp_path / tag),
                         "--quicklooks"]) == 0
        det = tmp_path / tag / "ang20200924t211102_cmf_v2y1_img_detections"
        csvf = det / "ang20200924t211102_cmf_v2y1_img_v2_minsal0p50_minppmm250p0.csv"
        outs[tag] = (open(csvf).read(), sorted(f for f in os.listdir(det)
                                               if f.endswith(".pdf")))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == [f"ang20200924t211102-{i}.pdf" for i in (1, 2, 3)]


def test_masks_cli_object_store_equals_jax(tmp_path):
    """--store-in fetches the radiance, --store-out uploads the mask; an
    existing product is uploaded again without being remade."""
    name = "ang20200924t211102_rdn_v2y1_img"
    src = tmp_path / "src"
    os.makedirs(src)
    _radiance(str(src), name, seed=4)
    inbucket = LocalObjectStore(str(tmp_path / "in"))
    for ext in (".hdr", ""):
        inbucket.put(str(src / (name + ext)), name + ext)
    txt = tmp_path / "files.txt"
    txt.write_text(name + "\n")
    outname = tmasks_cli.mask_output_name(name)
    masks = {}
    for tag, mod in (("port", tmasks_cli), ("jax", jmasks_cli)):
        args = ["--txt", str(txt), "--inpath", str(tmp_path / tag / "staging"),
                "--outpath", str(tmp_path / tag / "out"), "-M", "2px", "-A", "3",
                "-B", "1px", "--store-in", str(tmp_path / "in"),
                "--store-out", str(tmp_path / tag / "bucket"), "--device", "cpu"]
        os.makedirs(tmp_path / tag / "out")
        assert mod.main(args) == 0
        bucket = LocalObjectStore(str(tmp_path / tag / "bucket"))
        assert bucket.list() == [outname, outname + ".hdr"]
        masks[tag] = open_envi(os.path.join(bucket.root, outname)).load()
        os.remove(os.path.join(bucket.root, outname))
        assert mod.main(args) == 0                        # kept, uploaded again
        assert bucket.exists(outname)
    np.testing.assert_array_equal(masks["port"], masks["jax"])
    assert masks["port"].shape == (60, 16, 4)


@pytest.mark.parametrize("module", ["srcfinder_torch.flow.msf_flow",
                                    "srcfinder_torch.flow.ime_worker",
                                    "srcfinder_torch.flow.grib_cli",
                                    "srcfinder_torch.detect.salience_cli"])
def test_entry_points_run_as_modules(module):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-m", module, "--help"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:")
