"""The port's whole slice: srcfinder_torch.flow.pipeline_cli.run_flightline
(radiance -> CMF -> FCN saliency -> plume list -> IME) held against the
JAX package's end-to-end golden, tests/goldens/e2e_plumelist.npz.

The golden is the case of tests/test_goldens.py::_e2e_plumelist_case: a
96x32x425 synthetic cube, col_chunk=32, prob_thr=0.0, ppmm_thr=100.0,
IME on. It was taken with the masks stage on, through the fused cmf+masks
single read; masks enter neither the plume list nor the IME, so the port
is held to it both with and without them.

Tolerance: candidate ids and lat/lon exact (they follow from integer
pixel positions), CMF ppm*m stats and IME masses rtol 1e-4, with the
port's CMF in float64. The golden itself is the JAX package's f32 CMF.
The candidate's CMF minimum is 113 ppm*m, 1.5e-3 of the scene's maximum
(74,522), where f32 rounding moves a value by ~1e-4 relative in either
package: the golden is 7.2e-5 from the f64 value there, the port's f32
run 1.75e-4 (2.7e-7 of the scene maximum). Over the whole image the
port's f32 CMF errs no more than the JAX package's
(tests/test_torch_cmf.py::test_matched_filter_f32_error_tracks_jax_f32:
both within ~1.1e-6 of the image maximum), so the default f32 run is
held to the golden with ppm*m within 2e-6 of the scene maximum.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from srcfinder_tpu.core.envi import save_envi
from srcfinder_tpu.detect.cnn_cli import save_weights
from srcfinder_tpu.models import googlenet
from srcfinder_torch.core.envi import open_envi
from srcfinder_torch.flow import pipeline_cli

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "e2e_plumelist.npz")


@pytest.fixture(scope="module")
def flightline(tmp_path_factory):
    """The golden's inputs: radiance, library and Flax PRNGKey(0) weights."""
    d = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(12345)
    L, C, B = 96, 32, 425
    cube = np.abs(rng.normal(4.0, 0.5, (L, C, B))).astype(np.float32) + 0.5
    absorb = np.ones(B, np.float32)
    absorb[360:410] = 0.9
    cube[40:46, 10:14] *= absorb
    cube[0, 0, :] = -9999.0
    meta = {"data ignore value": -9999,
            "map info": ["UTM", "1", "1", "272247.15", "3992010.65",
                         "3.1", "3.1", "11", "North", "WGS-84",
                         "units=Meters", "rotation=0"],
            "wavelength": [f"{w:.2f}" for w in np.linspace(380, 2500, B)]}
    rdn = str(d / "ang20200924t211102_rdn_v2y1_img")
    save_envi(rdn + ".hdr", cube, metadata=meta, interleave="bil")
    lib = np.zeros((B, 3))
    lib[:, 0] = np.arange(1, B + 1)
    lib[:, 1] = np.linspace(380, 2500, B)
    lib[:, 2] = -np.abs(rng.normal(size=B)) * 0.1
    libf = str(d / "ang_ch4_unit_3col_425chan.txt")
    np.savetxt(libf, lib)
    model = googlenet(num_classes=2, dropout=0.0, dropout_aux=0.0)
    wf = str(d / "w.npz")
    save_weights(wf, model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 1)), train=False))
    return d, rdn, libf, wf


def _run(flightline, outname, dtype, log=None, rdn=None, **kw):
    d, rdn0, libf, wf = flightline
    return pipeline_cli.run_flightline(
        rdn or rdn0, libf, wf, str(d / outname), prob_thr=0.0, ppmm_thr=100.0,
        do_ime=True, col_chunk=32, dtype=dtype, device="cpu",
        progress=(log.append if log is not None else (lambda *a: None)), **kw)


@pytest.fixture(scope="module")
def run64(flightline):
    log = []
    return _run(flightline, "out64", "float64", log), log


@pytest.fixture(scope="module")
def run32(flightline):
    return _run(flightline, "out32", "float32")


@pytest.fixture(scope="module")
def run_masks(flightline):
    """The golden's own configuration: the f32 pipeline with masks, which
    runs the fused cmf+masks single read."""
    log = []
    return _run(flightline, "outmasks", "float32", log, do_masks=True), log


def _plume_rows(prods):
    df = pd.read_csv(prods["detections_csv"]).sort_values("Candidate ID")
    geo = df[["Plume Latitude (deg)", "Plume Longitude (deg)"]].to_numpy(np.float64)
    ppmm = df[["CMF Min (ppmm)", "CMF Max (ppmm)", "CMF Median (ppmm)",
               "CMF MAD (ppmm)"]].to_numpy(np.float64)
    ime = np.sort(pd.read_csv(prods["ime_csv"])["ime_kg"].to_numpy(np.float64))
    return df["Candidate ID"].to_numpy(np.str_), geo, ppmm, ime


def test_e2e_plumelist_matches_golden(flightline, run64):
    prods, log = run64
    assert [m for m in log if m.startswith("[STAGE]")][::2] == [
        "[STAGE] cmf", "[STAGE] fcn", "[STAGE] salience", "[STAGE] ime"]
    ids, geo, ppmm, ime = _plume_rows(prods)
    gold = np.load(GOLDEN)
    np.testing.assert_array_equal(ids, gold["a00"])
    np.testing.assert_array_equal(geo, gold["a01"])
    np.testing.assert_allclose(ppmm, gold["a02"], rtol=1e-4)
    np.testing.assert_allclose(ime, gold["a03"], rtol=1e-4)
    assert set(prods["timers"]) == {"cmf", "fcn", "salience", "ime"}
    assert os.path.exists(prods["detections_xlsx"])

    sal = open_envi(prods["saliency"]).load()[..., 0]
    assert sal[0, 0] == -9999.0                       # nodata re-stamped
    valid = sal != -9999.0
    assert ((sal[valid] >= 0) & (sal[valid] <= 1)).all()
    cmf = open_envi(prods["cmf"]).load()
    assert cmf.shape == (96, 32, 4) and cmf[0, 0, 3] == -9999.0

    # a second run finds every product and skips every stage
    rerun = []
    again = _run(flightline, "out64", "float64", rerun)
    assert again["timers"] == {}
    assert sum(m.startswith("[SKIP]") for m in rerun) == 4
    assert not any(p.endswith(".part") for p in os.listdir(
        os.path.dirname(prods["cmf"])))


def test_e2e_f32_matches_golden(run32):
    """The default f32 pipeline against the golden (the JAX package's f32
    run): same candidates and locations, ppm*m stats within 2e-6 of the
    scene's largest |ppm*m|, IME masses rtol 1e-4."""
    ids, geo, ppmm, ime = _plume_rows(run32)
    gold = np.load(GOLDEN)
    np.testing.assert_array_equal(ids, gold["a00"])
    np.testing.assert_array_equal(geo, gold["a01"])
    cmf = open_envi(run32["cmf"]).load()[..., 3]
    scale = np.abs(cmf[cmf != -9999.0]).max()
    np.testing.assert_allclose(ppmm, gold["a02"], rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(ime, gold["a03"], rtol=1e-4)


def test_e2e_f32_tracks_f64(run32, run64):
    """The default f32 CMF: same candidates and locations as the f64 run,
    CMF image within the f32 envelope (5e-4 of the scene maximum)."""
    p32, p64 = run32, run64[0]
    ids32, geo32, _, _ = _plume_rows(p32)
    ids64, geo64, _, _ = _plume_rows(p64)
    np.testing.assert_array_equal(ids32, ids64)
    np.testing.assert_array_equal(geo32, geo64)
    c32 = open_envi(p32["cmf"]).load()[..., 3]
    c64 = open_envi(p64["cmf"]).load()[..., 3]
    np.testing.assert_array_equal(c32 == -9999.0, c64 == -9999.0)
    assert np.abs(c32 - c64).max() / np.abs(c64).max() < 5e-4


def test_pipeline_cli_main_and_device_guard(flightline, run32, capsys):
    """The CLI over the f32 run's output directory: every stage is found
    and skipped, and the products are listed."""
    d, rdn, libf, wf = flightline
    rc = pipeline_cli.main([rdn, "--library", libf, "--weights", wf,
                            "-o", str(d / "out32"), "--prob_thr", "0.0",
                            "--ppmm_thr", "100", "--col_chunk", "32",
                            "--ime", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("[SKIP]") == 4
    assert f"detections_csv: {run32['detections_csv']}" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline_cli.run_flightline(rdn, libf, wf, str(d / "nocard"))


def test_pipeline_imports_no_jax():
    code = ("import sys, srcfinder_torch.flow.pipeline_cli, "
            "srcfinder_torch.cmf.cli, srcfinder_torch.masks.cli, "
            "srcfinder_torch.detect.fcn_cli, srcfinder_torch.core.prefetch, "
            "srcfinder_torch.cmf.kmeans, srcfinder_torch.cmf.matched_filter, "
            "srcfinder_torch.core.directio, srcfinder_torch.core.envi, "
            "srcfinder_torch.triage.profile, srcfinder_torch.triage.cli; "
            "assert 'flax' not in sys.modules, 'flax'; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'srcfinder_tpu' not in sys.modules, 'srcfinder_tpu'")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_e2e_with_masks_matches_golden_and_jax(flightline, run32, run_masks):
    """The fused cmf+masks read: the plume list equals the golden as the
    unfused run's does, the CMF product equals the unfused run's bit for
    bit, and the masks product equals the JAX package's
    (run_flightline(do_masks=True) runs srcfinder_tpu.masks.cli.
    masks_for_flightline on the host backend)."""
    from srcfinder_tpu.masks.cli import masks_for_flightline as jmasks
    prods, log = run_masks
    assert [m for m in log if m.startswith("[STAGE]")][::2] == [
        "[STAGE] cmf+masks (fused single-pass read)", "[STAGE] fcn",
        "[STAGE] salience", "[STAGE] ime"]
    assert set(prods["timers"]) == {"cmf+masks (fused single-pass read)", "read+masks",
                                    "cmf phase", "fcn", "salience", "ime"}
    ids, geo, ppmm, ime = _plume_rows(prods)
    ids32, geo32, ppmm32, ime32 = _plume_rows(run32)
    gold = np.load(GOLDEN)
    np.testing.assert_array_equal(ids, gold["a00"])
    np.testing.assert_array_equal(geo, gold["a01"])
    np.testing.assert_array_equal(ppmm, ppmm32)
    np.testing.assert_array_equal(ime, ime32)
    np.testing.assert_array_equal(open_envi(prods["cmf"]).load(),
                                  open_envi(run32["cmf"]).load())
    d, rdn, _, _ = flightline
    jname = jmasks(rdn + ".hdr", str(d), out_name="jax_msk",
                   device=jax.devices("cpu")[0])
    got = open_envi(prods["masks"]).load()
    np.testing.assert_array_equal(got, open_envi(str(d / jname)).load())
    assert got.shape == (96, 32, 4) and (got[0, 0] == -9999).all()
    assert os.path.basename(prods["masks"]) == "ang20200924t211102_msk_v2y1_img"

    rerun = []
    again = _run(flightline, "outmasks", "float32", rerun, do_masks=True)
    assert again["timers"] == {}
    assert "[SKIP] masks exist: " + prods["masks"] in rerun
    assert sum(m.startswith("[SKIP]") for m in rerun) == 5


def test_masks_without_wavelengths_warn_and_skip(flightline, run32):
    """No wavelength list: the masks are skipped with a warning before any
    device work, and the CMF is still written (its own read)."""
    from srcfinder_torch.core.envi import read_header, write_header
    d, rdn, _, _ = flightline
    bare = str(d / "ang20200924t211102_rdn_v2y1_nowl")
    meta = read_header(rdn + ".hdr")
    meta.pop("wavelength")
    write_header(bare + ".hdr", meta)
    os.symlink(rdn, bare)
    log = []
    prods = _run(flightline, "outnowl", "float32", log, rdn=bare, do_masks=True)
    assert any(m.startswith("[WARN] masks skipped: no wavelength") for m in log)
    assert prods["masks"] is None
    assert "[STAGE] cmf" in log and "masks" not in "".join(prods["timers"])
    np.testing.assert_array_equal(open_envi(prods["cmf"]).load(),
                                  open_envi(run32["cmf"]).load())


def test_masks_device_error_propagates(flightline, monkeypatch):
    """An error of the masks' device work (a RuntimeError, as a CUDA fault
    or an out-of-memory error is) propagates instead of being warn-skipped."""
    from srcfinder_torch.masks import sds

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")
    monkeypatch.setattr(sds, "pixel_masks", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _run(flightline, "outbroken", "float32", do_masks=True)


def test_pipeline_cli_bf16_dilated(flightline, run32, capsys):
    """--fcn-dtype bfloat16 --method dilated through main: the same
    candidates as the f32 phase run, saliency within 2e-2 of it."""
    d, rdn, libf, wf = flightline
    out = d / "outbf16"
    os.makedirs(out)
    for f in os.listdir(d / "out32"):              # reuse the f32 CMF
        if "_cmf_v2y1_img" in f and "saliency" not in f and "detections" not in f \
                and not f.endswith("_ime.csv"):
            os.symlink(d / "out32" / f, out / f)
    rc = pipeline_cli.main([rdn, "--library", libf, "--weights", wf, "-o", str(out),
                            "--prob_thr", "0.0", "--ppmm_thr", "100", "--col_chunk", "32",
                            "--fcn-dtype", "bfloat16", "--method", "dilated",
                            "--device", "cpu"])
    assert rc == 0
    assert "[SKIP] CMF exists" in capsys.readouterr().out
    sal = open_envi(str(out / "ang20200924t211102_cmf_v2y1_img_saliency")).load()
    ref = open_envi(run32["saliency"]).load()
    np.testing.assert_array_equal(sal == -9999.0, ref == -9999.0)
    assert np.abs(sal - ref).max() < 2e-2
