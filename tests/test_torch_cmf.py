"""The port's CMF (srcfinder_torch.cmf) held against the JAX package.

Same numpy inputs through both packages on the CPU. The port runs its
plain PyTorch versions of the two CUDA kernels here (masked moments and
the LOOCV sweep); the kernels themselves are held to those plain
versions on the card by chip_smoke.py.

Tolerances: f64 paths agree to rtol 1e-6 (the goldens' own tolerance;
the two packages differ only in summation order and LAPACK routine); f32
paths keep the f32-vs-f64 envelope of tests/test_cmf_f32.py (relative
error < 5e-4 of the column-set maximum, alpha index within 2 grid steps),
since f32 rounding in a different order is of that size.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from srcfinder_tpu.cmf import matched_filter as jmf
from srcfinder_tpu.cmf import pipeline as jpl
from srcfinder_tpu.core import envi as jenvi
from srcfinder_torch.cmf import matched_filter as tmf
from srcfinder_torch.cmf import pipeline as tpl
from srcfinder_torch.core import envi as tenvi
from srcfinder_torch.ops import loo, moments
from tests.test_cmf_parity import synth_radiance
from tests.test_cmf_pipeline import _write_flightline

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cmf_mf.npz")


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a if dtype is None
                                                 else np.asarray(a, dtype)))


def _relerr(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _golden_inputs():
    rng = np.random.default_rng(12345)
    x = synth_radiance(rng, L=96, C=6, B=16)
    abscf = -np.abs(rng.normal(size=16)) * 0.1
    return x, abscf


def test_valid_mask_matches_jax(rng):
    x = rng.normal(2.0, 1.0, (30, 5, 8))
    x[3, 1, 2] = np.nan
    x[7, 4, 0] = np.inf
    got = tmf.valid_mask(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmf.valid_mask(x)))
    assert not got.all() and got.any()


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_masked_moments_ref_matches_jax(rng, dtype, rtol):
    x = synth_radiance(rng, L=80, C=4, B=12).astype(dtype)
    m = np.asarray(jmf.valid_mask(x)).astype(dtype)
    x = np.where(m[:, :, None] > 0, x, 0.0).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = [np.asarray(a) for a in jmf.masked_moments(x, m)]
    got = [a.numpy() for a in moments.masked_moments_ref(_t(x), _t(m))]
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * np.abs(r).max())


def test_masked_moments_dispatches_plain_version_on_cpu(rng):
    x = _t(np.abs(rng.normal(3.0, 1.0, (20, 3, 5))))
    m = tmf.valid_mask(x).double()
    for a, b in zip(moments.masked_moments(x, m), moments.masked_moments_ref(x, m)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("fn", [moments.masked_moments, loo.loo_sweep])
def test_kernel_wrappers_refuse_other_devices(fn):
    """A wrapper runs its plain version only for CPU tensors; any other
    device either launches the kernel (CUDA) or raises."""
    z = torch.zeros(4, 2, 3, device="meta")
    args = (z, torch.zeros(2, device="meta")) if fn is moments.masked_moments \
        else (z, torch.zeros(2, 3, 5, device="meta"),
              torch.zeros(2, 5, device="meta"), torch.zeros(4, 2, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args)


def test_loo_nll_matches_jax(rng):
    """_loo_nll through the plain loo_sweep == the JAX _loo_nll (f64)."""
    L, C, B = 90, 4, 10
    x = synth_radiance(rng, L=L, C=C, B=B)
    m = np.asarray(jmf.valid_mask(x)).astype(np.float64)
    x = np.where(m[:, :, None] > 0, x, 0.0)
    n, mu, S = [a.numpy() for a in moments.masked_moments_ref(_t(x), _t(m))]
    d = np.sqrt(np.maximum(np.diagonal(S, axis1=1, axis2=2), 1e-30))
    lam, V = np.linalg.eigh(S / (d[:, :, None] * d[:, None, :]))
    Z = np.einsum("lcb,cbk->lck", (x - mu[None]) * m[:, :, None], V / d[:, :, None])
    logdiag = np.log(d)
    al = jmf.default_alphas()
    with jax.enable_x64(True):
        ref = np.asarray(jmf._loo_nll(jnp.asarray(lam), jnp.asarray(Z),
                                      jnp.asarray(logdiag), jnp.asarray(n),
                                      jnp.asarray(m), jnp.asarray(al), B))
    got = tmf._loo_nll(_t(lam), _t(Z), _t(logdiag), _t(n), _t(m), _t(al), B).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10)


def test_loo_sweep_ref_flags_nonpositive_q(rng):
    """q <= 0 on a valid line clears q_ok; on an invalid line it does not."""
    Z = _t(np.ones((3, 1, 2)))
    inv_glam = _t(np.full((1, 2, 2), 1.0))
    beta = _t(np.array([[0.1, 1.0]]))           # r = 2: q = 0.8, -1
    ssum, q_ok = loo.loo_sweep_ref(Z, inv_glam, beta, _t(np.ones((3, 1))))
    assert q_ok.tolist() == [[True, False]]
    np.testing.assert_allclose(ssum[0, 0].item(), 3 * (np.log(0.8) + 2 / 0.8))
    _, q_ok = loo.loo_sweep_ref(Z, inv_glam, beta, _t(np.zeros((3, 1))))
    assert q_ok.tolist() == [[True, True]]


def test_matched_filter_f64_matches_golden_and_jax():
    x, abscf = _golden_inputs()
    al = jmf.default_alphas()
    m = np.asarray(jmf.valid_mask(x))
    got = tmf.matched_filter_columns(_t(x, np.float64), _t(m, np.float64),
                                     _t(abscf), _t(al))
    with jax.enable_x64(True):
        ref = jmf.matched_filter_columns(x.astype(np.float64), m, abscf, al)
        ref_mf, ref_ai = np.asarray(ref.mf), np.asarray(ref.alpha_index)
        ref_nll = np.asarray(ref.nll)
    gold = np.load(GOLDEN)
    for target, ai in ((ref_mf, ref_ai), (gold["a00"], gold["a01"])):
        np.testing.assert_allclose(got.mf.numpy(), target, rtol=1e-6, atol=1e-12)
        np.testing.assert_array_equal(got.alpha_index.numpy(), ai)
    fin = np.isfinite(ref_nll)
    np.testing.assert_array_equal(np.isfinite(got.nll.numpy()), fin)
    np.testing.assert_allclose(got.nll.numpy()[fin], ref_nll[fin], rtol=1e-6)


def _well_conditioned(rng):
    L, C, B = 200, 4, 16
    A = rng.normal(size=(C, B, B)) * 0.2
    x = np.abs(np.einsum("lcb,cbd->lcd", rng.normal(size=(L, C, B)), A)
               + rng.uniform(2, 8, (C, B))) + 1e-3
    return x, -np.abs(rng.normal(size=B)) * 0.1


def _wild_band_scales(rng):
    L, C, B = 200, 4, 16
    s = 10.0 ** rng.uniform(-3, 3, size=B)
    x = np.abs((rng.normal(size=(L, C, B)) * 0.2 + 5.0) * s) + 1e-6
    return x, -np.abs(rng.normal(size=B)) * 0.1


@pytest.mark.parametrize("case", [_well_conditioned, _wild_band_scales])
def test_matched_filter_f32_within_envelope_of_jax(rng, case):
    x, abscf = case(rng)
    al = jmf.default_alphas(np.float32)
    m = np.asarray(jmf.valid_mask(x)).astype(np.float32)
    x32, a32 = x.astype(np.float32), abscf.astype(np.float32)
    ref = jmf.matched_filter_columns(x32, m, a32, al)
    got = tmf.matched_filter_columns(_t(x32), _t(m), _t(a32), _t(al))
    assert got.mf.dtype == torch.float32
    assert _relerr(got.mf.numpy(), np.asarray(ref.mf)) < 5e-4
    assert np.abs(got.alpha_index.numpy() - np.asarray(ref.alpha_index)).max() <= 2
    np.testing.assert_allclose(got.cond.numpy(), np.asarray(ref.cond), rtol=1e-2)


def test_matched_filter_f32_error_tracks_jax_f32():
    """The CMF window of the end-to-end golden's cube (96x32, 72 bands,
    plume included): against the f64 result, the port's f32 MF errs no
    more than the JAX package's f32 MF, over the whole image. Readings on
    x86 CPU: max |err| 8.6e-7 (port) and 1.09e-6 (JAX) of the image's
    largest |mf|, medians 1.8e-7 and 2.1e-7; so two f32 results differ by
    at most ~2e-6 of it (the tolerance of the f32 end-to-end check)."""
    rng = np.random.default_rng(12345)
    cube = np.abs(rng.normal(4.0, 0.5, (96, 32, 425))).astype(np.float32) + 0.5
    absorb = np.ones(425, np.float32)
    absorb[360:410] = 0.9
    cube[40:46, 10:14] *= absorb
    cube[0, 0, :] = -9999.0
    abscf = -np.abs(rng.normal(size=425))[350:422] * 0.1
    x = cube[:, :, 350:422]
    m = np.asarray(jmf.valid_mask(x)).astype(np.float32)
    al = jmf.default_alphas()
    with jax.enable_x64(True):
        r64 = jmf.matched_filter_columns(x.astype(np.float64), m.astype(np.float64),
                                         abscf, al)
        mf64, ai64 = np.asarray(r64.mf), np.asarray(r64.alpha_index)
    a32, al32 = abscf.astype(np.float32), al.astype(np.float32)
    rj = jmf.matched_filter_columns(x, m, a32, al32)
    rt = tmf.matched_filter_columns(_t(x), _t(m), _t(a32), _t(al32))
    valid = m > 0
    errs = {}
    for pkg, mf in (("jax", np.asarray(rj.mf)), ("port", rt.mf.numpy())):
        e = np.abs(mf - mf64)[valid] / np.abs(mf64).max()
        errs[pkg] = (e.max(), np.median(e))
    np.testing.assert_array_equal(rt.alpha_index.numpy(), ai64)
    np.testing.assert_array_equal(np.asarray(rj.alpha_index), ai64)
    assert errs["port"][0] <= 1.5 * errs["jax"][0], errs
    assert errs["port"][1] <= 1.5 * errs["jax"][1], errs
    assert errs["port"][0] < 2e-6, errs


def test_mf_column_stats_matches_jax(rng):
    mf = rng.normal(100.0, 30.0, (40, 6))
    m = (rng.uniform(size=(40, 6)) > 0.2).astype(np.float64)
    m[:, 3] = 0.0                                 # empty column keeps nodata
    with jax.enable_x64(True):
        ref = [np.asarray(a) for a in jmf.mf_column_stats(mf, m)]
    got = [a.numpy() for a in tmf.mf_column_stats(_t(mf), _t(m))]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12)
    assert got[0][3] == -9999.0


def _run_both(tmp_path, infile, libf, name, **kw):
    """robust_mf_image through both packages; both write the column CSV
    next to the input, so each CSV is read right after its run."""
    out = {}
    for pkg, fn, envi_mod, extra in (
            ("jax", jpl.robust_mf_image, jenvi, {"backend": "host"}),
            ("torch", tpl.robust_mf_image, tenvi, {"device": "cpu"})):
        outfile = str(tmp_path / f"{name}_{pkg}")
        res = fn(infile, libf, outfile, **kw, **extra)
        out[pkg] = (np.asarray(envi_mod.open_envi(outfile).load()),
                    pd.read_csv(res["colcsv"]))
    return out


def test_robust_mf_image_f64_matches_jax(tmp_path, rng):
    infile, libf, x, lib = _write_flightline(tmp_path, rng)
    out = _run_both(tmp_path, infile, libf, "f64", dtype=np.float64,
                    col_chunk=4, save_bgmeta=True)
    (gimg, gcsv), (rimg, rcsv) = out["torch"], out["jax"]
    assert gimg.shape == rimg.shape == (40, 10, 4)
    np.testing.assert_array_equal(gimg[..., :3], rimg[..., :3])
    np.testing.assert_array_equal(gimg[..., 3] == -9999, rimg[..., 3] == -9999)
    assert gimg[3, 2, 3] == -9999
    np.testing.assert_allclose(gimg, rimg, rtol=1e-6, atol=1e-9)
    assert list(gcsv.columns) == list(rcsv.columns)
    # the per-column average of a centred MF is ~1e-11: compare it absolutely
    np.testing.assert_allclose(gcsv.to_numpy(float), rcsv.to_numpy(float),
                               rtol=1e-6, atol=1e-9)
    gmeta = tenvi.open_envi(str(tmp_path / "f64_torch_bgmeta")).load()
    rmeta = jenvi.open_envi(str(tmp_path / "f64_jax_bgmeta")).load()
    np.testing.assert_array_equal(gmeta, rmeta)


def test_robust_mf_image_f32_cond_recompute_matches_jax(tmp_path, rng):
    """f32 with two near-singular columns: both packages recompute them
    in f64 (the port on its own device), so the whole image keeps the
    f32 envelope against the JAX f32 product and, on the recomputed
    columns, the f64 tolerance."""
    L, C = 200, 6
    infile, libf, x, lib = _write_flightline(tmp_path, rng, L=L, C=C)
    x = x.copy()
    nb = 422 - 350
    for c in (1, 4):
        U = rng.normal(size=(4, nb))
        x[:, c, 350:422] = np.abs(rng.normal(size=(L, 4)) @ U
                                  + rng.normal(size=(L, nb)) * 1e-4 + 6.0)
    tenvi.save_envi(infile + ".hdr", x, metadata=tenvi.open_envi(infile).metadata,
                    interleave="bil", force=True)
    out = _run_both(tmp_path, infile, libf, "f32", dtype=np.float32, col_chunk=3)
    got, ref = out["torch"][0][..., -1], out["jax"][0][..., -1]
    assert _relerr(got, ref) < 5e-4
    np.testing.assert_allclose(got[:, [1, 4]], ref[:, [1, 4]], rtol=1e-6)


def test_robust_mf_image_chunking_invariance(tmp_path, rng):
    infile, libf, x, lib = _write_flightline(tmp_path, rng, C=7)
    outs = []
    for chunk in (3, 7):
        o = str(tmp_path / f"o{chunk}")
        tpl.robust_mf_image(infile, libf, o, dtype=np.float64, col_chunk=chunk,
                            device="cpu")
        outs.append(tenvi.open_envi(o).load())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-10, atol=1e-8)


def test_robust_mf_image_preloaded_equals_disk_read(tmp_path, rng):
    infile, libf, x, lib = _write_flightline(tmp_path, rng, L=24, C=5)
    o1, o2 = str(tmp_path / "disk"), str(tmp_path / "pre")
    tpl.robust_mf_image(infile, libf, o1, dtype=np.float64, col_chunk=4, device="cpu")
    pre = (x[:, :, 350:422], x[:, :, [60, 42, 24]])
    tpl.robust_mf_image(infile, libf, o2, dtype=np.float64, col_chunk=4,
                        device="cpu", preloaded=pre)
    np.testing.assert_array_equal(tenvi.open_envi(o1).load(),
                                  tenvi.open_envi(o2).load())


def test_cmf_cli_smoke(tmp_path, rng):
    from srcfinder_torch.cmf import cli
    infile, libf, x, lib = _write_flightline(tmp_path, rng, L=24, C=4)
    outfile = str(tmp_path / "cli_out")
    rc = cli.main([infile, libf, outfile, "--dtype", "float64",
                   "--col_chunk", "4", "--device", "cpu"])
    assert rc == 0
    assert tenvi.open_envi(outfile).nbands == 4


def test_robust_mf_image_raises_without_card(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    infile, libf, x, lib = _write_flightline(tmp_path, rng, L=8, C=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.robust_mf_image(infile, libf, str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.robust_mf_image(infile, libf, str(tmp_path / "o"), bgmodes=2)
