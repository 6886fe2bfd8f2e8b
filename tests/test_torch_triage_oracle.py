"""The port's COVID systematics oracle (srcfinder_torch.triage.systematics
and .covid) held against the JAX package's on the same numpy-seeded
inputs, on the CPU: reports as equal dicts, the printout byte for byte,
``--expected`` exit codes, and column-stats CSVs regenerated from CMFs
(``device="cpu"``) with npix exact and the rest within rtol 1e-6, the
tolerance of tests/test_torch_triage.py. The cases are those of
tests/test_triage.py run through both packages."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from srcfinder_tpu.triage import covid as jcovid
from srcfinder_tpu.triage import profile as jprof
from srcfinder_tpu.triage import systematics as jsys
from srcfinder_torch.core import envi as tenvi
from srcfinder_torch.triage import covid as tcovid
from srcfinder_torch.triage import systematics as tsys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOLS = 60
SEVERITIES = [0, 0, 0.5, 1, 2, 0, 1, 2]

torch.set_num_threads(1)


def _med(rng, systematic):
    """A smooth cross-track profile; columnwise spikes when systematic
    (tests/test_triage.py::test_covid_oracle_harness)."""
    med = 500 + 30 * np.sin(np.linspace(0, 3, NCOLS)) + rng.normal(0, 0.5, NCOLS)
    if systematic:
        med[::7] += 500.0
    return med


def _campaign(root, rng, severities=SEVERITIES):
    """A curated list in the real file's comma format; the even
    flightlines have a column-stats CSV (the _clip spelling), the odd ones
    a 4-band CMF to profile. Returns (curated, stats_dir, cmf_dir)."""
    cmfdir, statsdir = os.path.join(root, "cmfs"), os.path.join(root, "stats")
    os.makedirs(cmfdir)
    os.makedirs(statsdir)
    names = []
    for i, s in enumerate(severities):
        name = f"ang2020070{i}t00000{i}_ch4mf_v2y1_img"
        names.append(name)
        med = _med(rng, s >= 1)
        if i % 2 == 0:
            pd.DataFrame({"npix": np.full(NCOLS, 100), "med": med,
                          "mad": np.full(NCOLS, 5.0), "p05": med - 10,
                          "p95": med + 10}).to_csv(
                os.path.join(statsdir, f"{name}_clip_column_stats.csv"), index=False)
        else:
            cmf = np.zeros((80, NCOLS, 4), np.float32)
            cmf[..., 3] = med[None, :] + rng.normal(0, 5, (80, NCOLS))
            cmf[0, :3, 3] = -9999.0
            tenvi.save_envi(os.path.join(cmfdir, name + ".hdr"), cmf,
                            metadata={"data ignore value": -9999}, interleave="bip")
    curated = os.path.join(root, "COVID_systematics.txt")
    with open(curated, "w") as f:
        f.writelines(f"{n}, {s}\n" for n, s in zip(names, severities))
    return curated, statsdir, cmfdir


def _two_campaigns(tmp_path, rng):
    """One campaign and a copy of it: the JAX run and the port's run each
    regenerate their own CSVs."""
    curated, statsdir, cmfdir = _campaign(str(tmp_path / "j"), rng)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    tdir = str(tmp_path / "t")
    return ((curated, statsdir, cmfdir),
            (os.path.join(tdir, "COVID_systematics.txt"), os.path.join(tdir, "stats"),
             os.path.join(tdir, "cmfs")))


def test_curated_list_comma_format(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("ang20200708t192518_ch4mf_v2y1_img, 2\n\n"
                 "ang20200708t193143_ch4mf_v2y1_img, 0.5\n"
                 "ang20200708t194000_ch4mf_v2y1_img 1\nlonely\n")
    for load in (tsys.load_systematics_list, tcovid.load_curated_list):
        names, sev = load(str(p))
        ref = jcovid.load_curated_list(str(p))
        assert names == ref[0] == jsys.load_systematics_list(str(p))[0]
        assert names[0] == "ang20200708t192518_ch4mf_v2y1_img"
        np.testing.assert_array_equal(sev, ref[1])
        assert sev.tolist() == [2.0, 0.5, 1.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_report_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sev = rng.choice([0.0, 0.5, 1.0, 2.0], 280)
    result = rng.integers(0, 2, 280).astype(float)
    got, ref = tsys.confusion_report(sev, result), jsys.confusion_report(sev, result)
    assert got == ref and list(got) == list(ref)
    assert tcovid.format_report(sev, got, "x.txt") == jcovid.format_report(sev, ref, "x.txt")


def test_systematics_detector_matches_jax():
    rng = np.random.default_rng(0)
    med = 100 + np.sin(np.linspace(0, 3, 598)) * 5 + rng.normal(0, 0.5, 598)
    bad = med.copy()
    bad[300] += 60
    for m in (med, bad):
        assert tsys.systematics_count(m) == jprof.systematics_count(m)
        assert tsys.flag_systematics(m) == jprof.flag_systematics(m)
    assert tsys.flag_systematics(med) == 0 and tsys.flag_systematics(bad) == 1


def test_validate_systematics_matches_jax(tmp_path, rng):
    """A mini oracle over CSVs in the plain spelling, with avg in place of
    med in one of them (the validator's fallback), and a missing CSV."""
    names, sev = [], []
    for i in range(6):
        name = f"ang2020010{i}t000000_cmf_v1x"
        med = _med(rng, i in (2, 5))
        col = "avg" if i == 3 else "med"
        pd.DataFrame({"npix": np.full(NCOLS, 50), col: med}).to_csv(
            tmp_path / f"{name}_column_stats.csv", index=False)
        names.append(name)
        sev.append(2.0 if i in (2, 5) else 0.0)
    got = tsys.validate_systematics(names, np.array(sev), str(tmp_path))
    ref = jsys.validate_systematics(names, np.array(sev), str(tmp_path))
    assert got == ref
    assert got["strict"]["none_tp"] == 4 and got["strong_tp"] == 2
    for kw in ({"nadj_col": 5}, {"nsigma_col": 1.0}):
        assert tsys.validate_systematics(names, np.array(sev), str(tmp_path), **kw) == \
            jsys.validate_systematics(names, np.array(sev), str(tmp_path), **kw)
    with pytest.raises(FileNotFoundError):
        tsys.validate_systematics(["nope"], np.array([0.0]), str(tmp_path))


def test_find_stats_csv_spellings(tmp_path):
    for name in ("a_clip_column_stats.csv", "b_column_stats.csv", "c_clip_column_stats.csv",
                 "c_column_stats.csv"):
        (tmp_path / name).write_text("npix\n1\n")
    for n in ("a", "b", "c", "d"):
        assert tcovid._find_stats_csv(str(tmp_path), n) == \
            jcovid._find_stats_csv(str(tmp_path), n)
    assert tcovid._find_stats_csv(str(tmp_path), "c").endswith("c_clip_column_stats.csv")


def test_covid_oracle_matches_jax(tmp_path, rng):
    """The reference-format report of a campaign whose CSVs are half
    regenerated from CMFs: equal report dicts, equal printout bytes, the
    regenerated CSVs npix exactly and the rest within rtol 1e-6, the
    progress messages equal."""
    (jc, js, jm), (tc, ts, tm) = _two_campaigns(tmp_path, rng)
    jmsg, tmsg = [], []
    ref, rtext = jcovid.run_covid_oracle(jc, js, jm, progress=jmsg.append)
    got, gtext = tcovid.run_covid_oracle(tc, ts, tm, progress=tmsg.append, device="cpu")
    assert got == ref
    assert gtext == rtext
    assert tmsg == jmsg and len(tmsg) == 4
    assert got["strict"] == {"none_tp": 3, "none_fp": 0, "any_tp": 4, "any_fn": 1}
    assert got["strong_tp"] == 2 and got["weak_tp"] == 2
    regenerated = sorted(f for f in os.listdir(ts) if not f.endswith("_clip_column_stats.csv"))
    assert regenerated == sorted(f for f in os.listdir(js)
                                 if not f.endswith("_clip_column_stats.csv"))
    assert len(regenerated) == 4
    for f in regenerated:
        a, b = pd.read_csv(os.path.join(ts, f)), pd.read_csv(os.path.join(js, f))
        assert list(a.columns) == list(b.columns) == ["npix", "med", "mad", "p05", "p95"]
        np.testing.assert_array_equal(a["npix"], b["npix"])
        np.testing.assert_allclose(a.to_numpy(float), b.to_numpy(float), rtol=1e-6)
    # a second run keeps the CSVs (idempotent) and gives the same report
    assert tcovid.run_covid_oracle(tc, ts, tm, progress=tmsg.append, device="cpu") == \
        (got, gtext)
    assert len(tmsg) == 4


@pytest.mark.parametrize("change", [None, "No Systematics (True Positive) = 3"])
def test_covid_main_expected_exit_codes(tmp_path, rng, capsys, change):
    """``--expected`` set to the JAX package's printout: exit 0 and "ALL
    COUNTS MATCH" as the JAX main does, or exit 1 with the same MISMATCH
    lines when one count is changed."""
    (jc, js, jm), (tc, ts, tm) = _two_campaigns(tmp_path, rng)
    shutil.copytree(tmp_path / "j", tmp_path / "e")
    _, text = jcovid.run_covid_oracle(str(tmp_path / "e" / "COVID_systematics.txt"),
                                      str(tmp_path / "e" / "stats"),
                                      str(tmp_path / "e" / "cmfs"), progress=lambda *a: None)
    expected = tmp_path / "expected.txt"
    expected.write_text(text if change is None else
                        text.replace(change, change.replace("= 3", "= 99")))
    capsys.readouterr()
    rc_t = tcovid.main([tc, "--stats-dir", ts, "--cmf-dir", tm, "--expected", str(expected),
                        "--device", "cpu"])
    out_t = capsys.readouterr().out
    rc_j = jcovid.main([jc, "--stats-dir", js, "--cmf-dir", jm, "--expected", str(expected)])
    out_j = capsys.readouterr().out
    assert rc_t == rc_j == (0 if change is None else 1)
    assert out_t == out_j and out_t.count("profiling") == 4
    assert ("ALL COUNTS MATCH" in out_t) == (change is None)
    assert tcovid.parse_expected(str(expected)) == jcovid.parse_expected(str(expected))
    assert tcovid._parse_counts(text.splitlines()) == jcovid._parse_counts(text.splitlines())


def test_ensure_profiles_missing_raises(tmp_path, rng):
    """A flightline with neither a CSV nor a CMF raises in both packages;
    without --cmf-dir every CSV must exist."""
    curated, statsdir, cmfdir = _campaign(str(tmp_path), rng, severities=[0, 1])
    names, _ = tcovid.load_curated_list(curated)
    for ensure, kw in ((tcovid.ensure_profiles, {"device": "cpu"}),
                       (jcovid.ensure_profiles, {})):
        with pytest.raises(FileNotFoundError, match="1 flightlines"):
            ensure(names, statsdir, None, progress=lambda *a: None, **kw)
        with pytest.raises(FileNotFoundError, match="nope"):
            ensure(["nope"], statsdir, cmfdir, progress=lambda *a: None, **kw)


def test_covid_oracle_raises_without_card(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    curated, statsdir, cmfdir = _campaign(str(tmp_path), rng, severities=[0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcovid.main([curated, "--stats-dir", statsdir, "--cmf-dir", cmfdir])


def test_oracle_report_imports_no_torch(tmp_path, rng):
    """With every CSV present the oracle's process imports no torch (the
    detector is host numpy), and no jax or srcfinder_tpu."""
    curated, statsdir, cmfdir = _campaign(str(tmp_path), rng, severities=[0, 2, 0.5])
    tcovid.ensure_profiles(tcovid.load_curated_list(curated)[0], statsdir, cmfdir,
                           progress=lambda *a: None, device="cpu")
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1")
    out = subprocess.run([sys.executable, "-m", "srcfinder_torch", "covid-oracle", curated,
                          "--stats-dir", statsdir], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Successful Completion" in out.stdout
    imported = {line.split("|")[-1].strip().split(".")[0] for line in out.stderr.splitlines()
                if line.startswith("import time:")}
    assert "pandas" in imported
    assert not imported & {"torch", "jax", "jaxlib", "flax", "srcfinder_tpu"}
