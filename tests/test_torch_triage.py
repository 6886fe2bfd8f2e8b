"""The port's CMF triage (srcfinder_torch.triage) held against the JAX
package: column statistics (standard and robust), the systematics
detector, the column-stats CSV and the CLI. Both packages on the CPU;
column statistics in float32 as the CMF band is read, rtol 1e-6."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from srcfinder_tpu.triage import profile as jprof
from srcfinder_torch.core import envi as tenvi
from srcfinder_torch.triage import cli as tcli
from srcfinder_torch.triage import profile as tprof

torch.set_num_threads(1)


def _cmf_cases(rng):
    """A CMF band with masked pixels, a column of one pixel, a column of
    none, and an even count (the median interpolates)."""
    cmf = rng.normal(loc=100, scale=30, size=(60, 9)).astype(np.float32)
    mask = cmf > 0
    mask[:, 3] = False
    mask[7, 4], mask[np.arange(60) != 7, 4] = True, False
    mask[:40, 5] = True
    mask[40:, 5] = False
    return cmf, mask


@pytest.mark.parametrize("robust", [False, True])
def test_column_stats_matches_jax(rng, robust):
    cmf, mask = _cmf_cases(rng)
    ref = [np.asarray(s) for s in jprof.column_stats(jnp.asarray(cmf), jnp.asarray(mask),
                                                     robust=robust)]
    got = [s.numpy() for s in tprof.column_stats(torch.from_numpy(cmf),
                                                 torch.from_numpy(mask), robust=robust)]
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == np.int32
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, rtol=1e-6, equal_nan=True)
    assert np.isnan(got[1][3]) and not np.isnan(got[1][4])


def _profiles():
    rng = np.random.default_rng(0)
    med = 100 + np.sin(np.linspace(0, 3, 598)) * 5 + rng.normal(0, 0.5, 598)
    bad = med.copy()
    bad[300] += 60
    two = bad.copy()
    two[100] += 80
    gaps = two.copy()
    gaps[[5, 200]] = np.nan
    return {"clean": med, "one": bad, "two": two, "nan": gaps}


@pytest.mark.parametrize("name", ["clean", "one", "two", "nan"])
def test_systematics_match_jax(name):
    med = _profiles()[name]
    assert tprof.systematics_count(med) == jprof.systematics_count(med)
    assert tprof.flag_systematics(med) == jprof.flag_systematics(med)
    assert tprof.systematics_count(med, nadj_col=5, nsigma_col=2.0) == \
        jprof.systematics_count(med, nadj_col=5, nsigma_col=2.0)
    assert tprof.flag_systematics(med) == (0 if name == "clean" else 1)


def _write_cmf(path, rng, L=80, C=40):
    img = np.zeros((L, C, 4), np.float32)
    img[..., :3] = 5.0
    cmf = rng.normal(loc=300, scale=200, size=(L, C)).astype(np.float32)
    cmf[:, C // 2] += 500.0
    cmf[0, :5] = -9999.0
    cmf[3, 3] = np.nan
    img[..., 3] = cmf
    tenvi.save_envi(path + ".hdr", img, metadata={"data ignore value": -9999},
                    interleave="bip")


@pytest.mark.parametrize("robust", [False, True])
def test_summarize_cmf_csv_matches_jax(tmp_path, rng, robust):
    src = str(tmp_path / "ang20200101t000000_cmf_v1x")
    _write_cmf(src, rng)
    tcsv = tprof.summarize_cmf(src, str(tmp_path / "t"), use_robust_stats=robust,
                               device="cpu")
    jcsv = jprof.summarize_cmf(src, str(tmp_path / "j"), use_robust_stats=robust)
    got, ref = pd.read_csv(tcsv), pd.read_csv(jcsv)
    assert list(got.columns) == list(ref.columns)
    np.testing.assert_array_equal(got["npix"], ref["npix"])
    np.testing.assert_allclose(got.to_numpy(float), ref.to_numpy(float), rtol=1e-6)
    assert tprof.summarize_cmf(src, str(tmp_path / "t"), use_robust_stats=robust,
                               device="cpu") is False
    assert tprof.summarize_cmf(src, str(tmp_path / "t"), use_robust_stats=robust,
                               overwrite=True, device="cpu") == tcsv


def test_triage_cli_profiles_and_plots(tmp_path, rng, capsys):
    files = []
    for i in range(3):
        f = str(tmp_path / f"ang2020010{i}t000000_cmf_v1x")
        _write_cmf(f, rng, L=30, C=12)
        files.append(f)
    out = str(tmp_path / "stats")
    rc = tcli.main(["--robust", "-j", "2", "--plot", "-v", "--outdir", out,
                    "--device", "cpu", *files])
    assert rc == 0
    for f in files:
        csvf = os.path.join(out, os.path.basename(f) + "_column_stats.csv")
        df = pd.read_csv(csvf)
        assert list(df.columns) == ["npix", "med", "mad", "p05", "p95"] and len(df) == 12
        assert os.path.getsize(os.path.splitext(csvf)[0] + ".pdf") > 1000
        assert os.path.getsize(os.path.splitext(csvf)[0] + "_rwin.pdf") > 1000
    assert capsys.readouterr().out.count("->") == 3


def test_summarize_cmf_raises_without_card(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = str(tmp_path / "x_cmf")
    _write_cmf(src, rng, L=8, C=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.summarize_cmf(src, str(tmp_path))
