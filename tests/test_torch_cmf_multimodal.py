"""The port's multimodal CMF held against the JAX package: the Cholesky
whitener (``T=``), the LOOCV count ``n_loo``, masked PCA, k-means, the
per-mode fits with rejection and ``regfull``, the image pipeline with its
per-(column, mode) f64 gate, and the CLIs' multimodal flags.

Same numpy inputs through both packages on the CPU, in float64 (JAX under
``jax.enable_x64``); the port runs the plain versions of its two CUDA
kernels here, and chip_smoke.py holds the kernels to those on the card.
Tolerances: rtol 1e-6 on matched-filter values and nll (the f64
tolerance of tests/test_torch_cmf.py), 1e-8 on PCA projections and
centroids, which involve no LOOCV. torch cannot reproduce
``jax.random.gumbel``, so where both k-means must start from the same
points the JAX package's seeds are passed to the port as ``init_index``;
elsewhere the port seeds itself and labels are compared up to a
permutation of the modes.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from srcfinder_tpu.cmf import cli as jcli
from srcfinder_tpu.cmf import kmeans as jkm
from srcfinder_tpu.cmf import matched_filter as jmf
from srcfinder_tpu.cmf import pipeline as jpl
from srcfinder_tpu.core import envi as jenvi
from srcfinder_torch.cmf import cli as tcli
from srcfinder_torch.cmf import kmeans as tkm
from srcfinder_torch.cmf import matched_filter as tmf
from srcfinder_torch.cmf import pipeline as tpl
from srcfinder_torch.core import envi as tenvi
from tests.test_cmf_parity import synth_radiance
from tests.test_cmf_pipeline import _write_flightline

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


def _swap_map(got, ref, k):
    """Per column, the permutation of mode ids that maps ``got`` labels to
    ``ref`` labels on the rows where they are given (L, C) -> (C, k); fails
    unless one exists."""
    perm = np.zeros((got.shape[1], k), int)
    for c in range(got.shape[1]):
        for g in range(k):
            r = np.unique(ref[got[:, c] == g, c])
            assert r.size <= 1, f"column {c}: label {g} maps to {r}"
            perm[c, g] = r[0] if r.size else g
    return perm


# ------------------------------------------------------------ T= whitener
def _regfull_problem():
    """test_regfull_target's data (test_cmf_pipeline.py:153)."""
    rng = np.random.default_rng(7)
    L, C, B = 90, 2, 8
    x = np.abs(rng.normal(loc=4.0, size=(L, C, B))) + 0.5
    abscf = -np.abs(rng.normal(size=B)) * 0.1
    Tfull = np.stack([np.cov(x[:, c, :].T, ddof=1) for c in range(C)])
    return x, abscf, Tfull


def test_cholesky_whitener_matches_jax_and_oracle():
    x, abscf, Tfull = _regfull_problem()
    L, C, B = x.shape
    alphas = jmf.default_alphas()
    m = np.ones((L, C))
    with jax.enable_x64(True):
        ref = jmf.matched_filter_columns(x, m, abscf, alphas, T=jnp.asarray(Tfull))
    got = tmf.matched_filter_columns(_t(x), _t(m), _t(abscf), _t(alphas), T=_t(Tfull))
    np.testing.assert_array_equal(got.alpha_index.numpy(), _np(ref.alpha_index))
    np.testing.assert_allclose(got.mf.numpy(), _np(ref.mf), rtol=1e-6, atol=1e-12)
    fin = np.isfinite(_np(ref.nll))
    np.testing.assert_array_equal(np.isfinite(got.nll.numpy()), fin)
    np.testing.assert_allclose(got.nll.numpy()[fin], _np(ref.nll)[fin], rtol=1e-6)
    # the numpy oracle of test_regfull_target: T == S, so G = (n beta + a) S
    for c in range(C):
        S = Tfull[c]
        X = x[:, c, :] - x[:, c, :].mean(axis=0)
        nll = np.full(len(alphas), np.inf)
        for i, a in enumerate(alphas):
            beta = (1 - a) / (L - 1.0)
            G = L * beta * S + a * S
            _, logdet = np.linalg.slogdet(G)
            r_k = (X @ np.linalg.inv(G) * X).sum(axis=1)
            q = 1 - beta * r_k
            nll[i] = (0.5 * (B * np.log(2 * np.pi) + logdet)
                      + (np.log(q) + r_k / q).sum() / (2 * L))
        assert int(np.argmin(nll)) == int(got.alpha_index[c])


def test_target_not_positive_definite_gives_nan_cond():
    """A target whose Cholesky fails gives NaN (as the JAX package's
    cholesky does) instead of raising, so the f32 gate flags the column."""
    x, abscf, Tfull = _regfull_problem()
    Tbad = Tfull.copy()
    Tbad[1] = -np.eye(x.shape[2])
    alphas = jmf.default_alphas()
    m = np.ones(x.shape[:2])
    got = tmf.matched_filter_columns(_t(x), _t(m), _t(abscf), _t(alphas), T=_t(Tbad))
    cond = got.cond.numpy()
    assert np.isfinite(cond[0]) and np.isnan(cond[1])
    with jax.enable_x64(True):
        ref = jmf.matched_filter_columns(x, m, abscf, alphas, T=jnp.asarray(Tbad))
    assert np.isnan(_np(ref.cond)[1])
    np.testing.assert_allclose(got.mf.numpy()[:, 0], _np(ref.mf)[:, 0], rtol=1e-6)


# ------------------------------------------------------------------ n_loo
@pytest.mark.parametrize("regfull", [False, True])
def test_n_loo_matches_jax(rng, regfull):
    """Per-mode fits with the full column's count behind beta, on the
    pseudo-cluster labels of test_parity_multimodal_cluster_nuse."""
    x = synth_radiance(rng)
    B = x.shape[2]
    abscf = -np.abs(rng.normal(size=B)) * 0.1
    alphas = jmf.default_alphas()
    m = _np(jmf.valid_mask(x))
    labels = ((np.cumsum(m, axis=0) - 1) % 2).astype(np.int32)
    n_full = m.sum(axis=0).astype(np.float64)
    xz = np.where(m[:, :, None], x, 0.0)
    Tfull = None
    if regfull:
        with jax.enable_x64(True):
            Tfull = _np(jmf.masked_moments(jnp.asarray(xz), jnp.asarray(m.astype(np.float64)))[2])
    for k in (0, 1):
        mask_k = (m & (labels == k)).astype(np.float64)
        with jax.enable_x64(True):
            ref = jmf.matched_filter_columns(
                x, mask_k, abscf, alphas, T=None if Tfull is None else jnp.asarray(Tfull),
                n_loo=jnp.asarray(n_full))
        got = tmf.matched_filter_columns(
            _t(x), _t(mask_k), _t(abscf), _t(alphas),
            T=None if Tfull is None else _t(Tfull), n_loo=_t(n_full))
        np.testing.assert_array_equal(got.alpha_index.numpy(), _np(ref.alpha_index))
        np.testing.assert_allclose(got.mf.numpy(), _np(ref.mf), rtol=1e-6, atol=1e-12)


# -------------------------------------------------------- PCA and k-means
def test_masked_pca_project_matches_jax(rng):
    x = synth_radiance(rng, L=150, C=4, B=14)
    m = _np(jmf.valid_mask(x))
    xz = np.where(m[:, :, None], x, 0.0)
    with jax.enable_x64(True):
        ref = _np(jkm.masked_pca_project(jnp.asarray(xz), jnp.asarray(m), 5))
    got = tkm.masked_pca_project(_t(xz), _t(m), 5).numpy()
    assert got.shape == ref.shape == (150, 4, 5)
    # eigenvectors are defined up to sign: align each (column, axis)
    sign = np.sign((got * ref).sum(axis=0))
    assert (sign != 0).all()
    np.testing.assert_allclose(got * sign[None], ref, rtol=1e-8,
                               atol=1e-8 * np.abs(ref).max())


def _three_modes(rng):
    """test_kmeans_three_modes_and_per_column_seeding's data."""
    L, C, P = 120, 5, 3
    centers = rng.normal(scale=10.0, size=(C, 3, P))
    z = np.empty((L, C, P))
    true_lab = np.zeros((L, C), int)
    for c in range(C):
        for k in range(3):
            sl = slice(k * (L // 3), (k + 1) * (L // 3))
            z[sl, c] = centers[c, k] + rng.normal(scale=0.1, size=(L // 3, P))
            true_lab[sl, c] = k
    return z, np.ones((L, C)), 3, centers, true_lab


def _bimodal(rng):
    """Two overlapping modes per column, with masked rows."""
    L, C, P = 200, 4, 4
    z = rng.normal(size=(L, C, P))
    z[: L // 2, :, 0] += 2.5
    m = (rng.uniform(size=(L, C)) > 0.1).astype(np.float64)
    return z, m, 2, None, None


@pytest.mark.parametrize("case", [_three_modes, _bimodal])
def test_kmeans_columns_matches_jax_from_its_seeds(rng, case):
    z, m, k, _, _ = case(rng)
    with jax.enable_x64(True):
        seeds = _np(jkm._kpp_init(jnp.asarray(z), jnp.asarray(m), k, jax.random.PRNGKey(0)))
        ref_lab, ref_cent = (_np(a) for a in jkm.kmeans_columns(
            jnp.asarray(z), jnp.asarray(m), k, iters=25, seed=0))
    # each seed is a row of its own column: recover the row index
    d = ((z.transpose(1, 0, 2)[:, None, :, :] - seeds[:, :, None, :]) ** 2).sum(-1)
    init = d.argmin(axis=2)                                    # (C, k)
    assert np.allclose(d.min(axis=2), 0.0)
    lab, cent = tkm.kmeans_columns(_t(z), _t(m), k, iters=25, init_index=_t(init))
    np.testing.assert_array_equal(lab.numpy(), ref_lab)
    np.testing.assert_allclose(cent.numpy(), ref_cent, rtol=1e-8, atol=1e-12)


def test_kmeans_own_seeding_is_per_column(rng):
    """The port's k-means++ seeding measures each point against its own
    column's seeds: the property test_kmeans_three_modes_and_per_column_
    seeding holds the JAX package to, at k = 3."""
    z, m, k, centers, true_lab = _three_modes(rng)
    lab, cent = tkm.kmeans_columns(_t(z.astype(np.float32)), _t(m.astype(np.float32)),
                                   k, iters=25, seed=0)
    lab, cent = lab.numpy(), cent.numpy()
    assert lab.dtype == np.int32
    for c in range(z.shape[1]):
        for j in range(k):
            got = lab[true_lab[:, c] == j, c]
            assert (got == got[0]).all()
        assert len(np.unique(lab[:, c])) == 3
        for j in range(k):
            assert np.linalg.norm(centers[c] - cent[c, j][None], axis=1).min() < 1.0
    again = tkm.kmeans_columns(_t(z.astype(np.float32)), _t(m.astype(np.float32)), k,
                               seed=0)[0].numpy()
    np.testing.assert_array_equal(again, lab)


# ----------------------------------------------------- multimodal columns
def _known_partition(rng):
    """test_multimodal_recovers_known_partition's data."""
    L, C, B = 160, 3, 12
    mean1 = np.full(B, 3.0) + rng.uniform(0, 0.5, B)
    mean2 = np.full(B, 9.0) + rng.uniform(0, 0.5, B)
    x = np.empty((L, C, B))
    for c in range(C):
        half = L // 2
        x[:half, c] = mean1 + rng.normal(size=(half, B)) * 0.2
        x[half:, c] = mean2 + rng.normal(size=(L - half, B)) * 0.2
    return np.abs(x), -np.abs(rng.normal(size=B)) * 0.1


def _rejection(rng):
    """test_multimodal_rejection's data: a 5-pixel outlier cluster."""
    L, C, B = 140, 2, 10
    x = np.abs(rng.normal(loc=5.0, size=(L, C, B))) + 0.5
    x[:5] *= 10.0
    return x, -np.abs(rng.normal(size=B)) * 0.1


@pytest.mark.parametrize("case,reject,regfull", [
    (_known_partition, False, False), (_known_partition, True, True),
    (_rejection, True, False), (_rejection, True, True)])
def test_multimodal_matches_jax(rng, case, reject, regfull):
    x, abscf = case(rng)
    alphas = jmf.default_alphas()
    with jax.enable_x64(True):
        m = _np(jmf.valid_mask(x))
        ref = jmf.matched_filter_columns_multimodal(
            x, m, abscf, alphas, bgmodes=2, pcadim=4, reject=reject, regfull=regfull)
        ref = ref._replace(**{f: _np(getattr(ref, f)) for f in ref._fields})
    got = tmf.matched_filter_columns_multimodal(
        _t(x), _t(m.astype(np.float64)), _t(abscf), _t(alphas), bgmodes=2, pcadim=4,
        reject=reject, regfull=regfull)
    got = got._replace(**{f: getattr(got, f).numpy() for f in got._fields})
    perm = _swap_map(got.labels, ref.labels, 2)
    assert got.labels.dtype == got.alpha_pix.dtype == np.int32
    np.testing.assert_array_equal(got.valid, ref.valid)
    cols = np.arange(x.shape[1])[:, None]
    inv = np.argsort(perm, axis=1)            # ref mode j is got mode inv[c, j]
    np.testing.assert_array_equal(got.rejected[cols, inv], ref.rejected)
    np.testing.assert_array_equal(got.counts[cols, inv], ref.counts)
    np.testing.assert_array_equal(got.alpha_pix, ref.alpha_pix)
    np.testing.assert_allclose(got.mf, ref.mf, rtol=1e-6, atol=1e-8)
    if case is _rejection:
        assert ref.rejected.any()


# --------------------------------------------------------- image pipeline
def _two_mode_flightline(tmp_path, rng, L=240, C=6, rank4=()):
    """test_f32_cond_fallback_multimodal's scene: two background modes in
    every column (the first half of the lines raised by 8); in the
    columns ``rank4`` the bright mode is rank 4 in the active window."""
    infile, libf, x, lib = _write_flightline(tmp_path, rng, L=L, C=C)
    x = x.copy()
    x[: L // 2] += 8.0
    nb = 422 - 350
    for c in rank4:
        U = rng.normal(size=(4, nb))
        x[: L // 2, c, 350:422] = np.abs(rng.normal(size=(L // 2, 4)) @ U
                                         + rng.normal(size=(L // 2, nb)) * 1e-4 + 12.0)
    tenvi.save_envi(infile + ".hdr", x, metadata=tenvi.open_envi(infile).metadata,
                    interleave="bil", force=True)
    return infile, libf


def _image(path):
    return np.asarray(tenvi.open_envi(path).load())


def test_robust_mf_image_bgmodes2_f64_matches_jax(tmp_path, rng):
    infile, libf = _two_mode_flightline(tmp_path, rng, L=96, C=5)
    kw = dict(bgmodes=2, pcadim=4, dtype=np.float64, col_chunk=3, save_bgmeta=True)
    jres = jpl.robust_mf_image(infile, libf, str(tmp_path / "j"), backend="host", **kw)
    jcsv = pd.read_csv(jres["colcsv"])
    tres = tpl.robust_mf_image(infile, libf, str(tmp_path / "t"), device="cpu", **kw)
    tcsv = pd.read_csv(tres["colcsv"])
    got, ref = _image(str(tmp_path / "t")), _image(str(tmp_path / "j"))
    np.testing.assert_array_equal(got[..., 3] == -9999, ref[..., 3] == -9999)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tcsv.to_numpy(float), jcsv.to_numpy(float),
                               rtol=1e-6, atol=1e-9)
    gmeta, rmeta = _image(str(tmp_path / "t_bgmeta")), _image(str(tmp_path / "j_bgmeta"))
    _swap_map(gmeta[..., 0], rmeta[..., 0], 2)
    np.testing.assert_array_equal(gmeta[..., 1], rmeta[..., 1])
    assert tres["f64_columns"] == 0


def test_robust_mf_image_f32_multimodal_gate(tmp_path, rng):
    """The f32 per-(column, mode) gate: columns whose bright mode is
    near-singular are recomputed through the f64 multimodal path, so the
    image tracks the f64 one; without the gate those columns diverge (the
    JAX test's bounds, test_f32_cond_fallback_multimodal)."""
    infile, libf = _two_mode_flightline(tmp_path, rng, rank4=(1, 4))

    def run(name, **kw):
        out = str(tmp_path / name)
        res = tpl.robust_mf_image(infile, libf, out, col_chunk=3, bgmodes=2, pcadim=4,
                                  device="cpu", **kw)
        return _image(out)[..., -1], res["f64_columns"]

    mf64, _ = run("out64", dtype=np.float64)
    mf32, n_gated = run("out32", dtype=np.float32)
    mf32_raw, n_raw = run("out32raw", dtype=np.float32, cond_thresh=0.0)
    jout = str(tmp_path / "jax64")
    jpl.robust_mf_image(infile, libf, jout, col_chunk=3, bgmodes=2, pcadim=4,
                        dtype=np.float64, backend="host")
    scale = np.abs(mf64).max()
    # the rank-4 modes' whitened covariances have cond ~5e-12, which lifts
    # summation-order differences to ~1e-10 of the scene maximum in f64
    assert np.abs(mf64 - _image(jout)[..., -1]).max() < 1e-9 * scale
    err_fb = np.abs(mf32 - mf64).max() / scale
    err_raw = np.abs(mf32_raw[:, [1, 4]] - mf64[:, [1, 4]]).max() / scale
    assert err_fb < 5e-3
    assert err_raw > 10 * err_fb
    assert n_gated >= 2 and n_raw == 0


def test_cmf_cli_multimodal_flags_match_jax(tmp_path, rng):
    """cmf.cli -k 2 -f -r -m: the header's model parameters equal the JAX
    package's, and the bgmeta image holds both modes' ids."""
    infile, libf, x, lib = _write_flightline(tmp_path, rng, L=64, C=4)
    args = [infile, libf, None, "--dtype", "float64", "--col_chunk", "4",
            "-k", "2", "-f", "-r", "-m"]
    for main, name, extra in ((tcli.main, "t", ["--device", "cpu"]), (jcli.main, "j", [])):
        args[2] = str(tmp_path / name)
        assert main(args + extra) == 0
    timg, jimg = tenvi.open_envi(str(tmp_path / "t")), jenvi.open_envi(str(tmp_path / "j"))
    assert timg.nbands == 4
    assert timg.metadata["model parameters"] == jimg.metadata["model parameters"]
    assert "bgmodel=multimodal" in ",".join(timg.metadata["model parameters"])
    bg = _image(str(tmp_path / "t_bgmeta"))
    assert bg.shape == (64, 4, 2) and bg.dtype == np.int16
    assert len(np.unique(bg[..., 0])) >= 2
    parser = tcli.build_parser()
    assert {a.dest: a.default for a in parser._actions if a.dest in
            ("kmeans", "pcadim", "reject", "full")} == {
        a.dest: a.default for a in jcli.build_parser()._actions if a.dest in
        ("kmeans", "pcadim", "reject", "full")}


def test_pipeline_cli_bgmodes_fused_equals_unfused(tmp_path, rng):
    """pipeline_cli --bgmodes 2 --masks: the fused read's multimodal CMF
    equals the unfused run's bit for bit."""
    from srcfinder_torch.flow import pipeline_cli
    from srcfinder_torch.models.convert import save_weights, torch_state_dict_to_flax
    from srcfinder_torch.models.googlenet import GoogLeNet

    L, C, B = 64, 16, 425
    x = np.abs(rng.normal(4.0, 0.5, (L, C, B))).astype(np.float32) + 0.5
    x[: L // 2] += 6.0
    meta = {"data ignore value": -9999,
            "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1", "11",
                         "North", "WGS-84", "units=Meters", "rotation=0"],
            "wavelength": [f"{w:.2f}" for w in np.linspace(380, 2500, B)]}
    rdn = str(tmp_path / "ang20200924t211102_rdn_v2y1_img")
    tenvi.save_envi(rdn + ".hdr", x, metadata=meta, interleave="bil")
    lib = np.zeros((B, 3))
    lib[:, 0] = np.arange(1, B + 1)
    lib[:, 1] = np.linspace(380, 2500, B)
    lib[:, 2] = -np.abs(rng.normal(size=B)) * 0.1
    libf = str(tmp_path / "ang_ch4_unit_3col_425chan.txt")
    np.savetxt(libf, lib)
    wf = str(tmp_path / "w.npz")
    model = GoogLeNet(num_classes=2, generator=torch.Generator().manual_seed(0))
    save_weights(wf, torch_state_dict_to_flax(model.state_dict()))

    rc = pipeline_cli.main([rdn, "--library", libf, "--weights", wf, "-o",
                            str(tmp_path / "fused"), "--bgmodes", "2", "--masks",
                            "--col_chunk", "8", "--prob_thr", "0.99", "--device", "cpu"])
    assert rc == 0
    log = []
    prods = pipeline_cli.run_flightline(rdn, libf, wf, str(tmp_path / "unfused"),
                                        bgmodes=2, col_chunk=8, prob_thr=0.99,
                                        device="cpu", progress=log.append)
    assert "[STAGE] cmf" in log
    name = os.path.basename(prods["cmf"])
    fused = tenvi.open_envi(str(tmp_path / "fused" / name))
    assert "bgmodel=multimodal" in ",".join(fused.metadata["model parameters"])
    np.testing.assert_array_equal(fused.load(), tenvi.open_envi(prods["cmf"]).load())


# ------------------------------------------------------------------ spans
SMALL_MODE_COLUMNS = (1, 4)


def _small_mode_flightline(tmp_path, rng):
    """Two background modes in every column of a 240 x 5 scene (the first
    100 lines raised by 8), except the columns SMALL_MODE_COLUMNS, where
    only the first 20 are: a mode under ``int((B - 1) * 1.2)`` = 85 rows,
    which ``reject`` rejects."""
    infile, libf, x, _ = _write_flightline(tmp_path, rng, L=240, C=5)
    x = x.copy()
    for c in range(x.shape[1]):
        x[: 20 if c in SMALL_MODE_COLUMNS else 100, c] += 8.0
    tenvi.save_envi(infile + ".hdr", x, metadata=tenvi.open_envi(infile).metadata,
                    interleave="bil", force=True)
    return infile, libf


def _image_spans(run):
    """The spans of the product ``run()`` makes: its ``cmf.image`` root's
    trace, by name, and the root."""
    from srcfinder_torch import trace
    run()
    root = trace.spans()[-1]
    assert root.name == "cmf.image" and root.parent_id is None
    by = {}
    for s in trace.spans(root.trace_id):
        by.setdefault(s.name, []).append(s)
    return by, root


@pytest.fixture
def small_mode_spans(tmp_path, rng):
    """col_chunk 3 over 5 columns: the second chunk holds one zero column
    of padding, which the mode counts must leave out."""
    infile, libf = _small_mode_flightline(tmp_path, rng)
    out = str(tmp_path / "mm")
    by, root = _image_spans(lambda: tpl.robust_mf_image(
        infile, libf, out, bgmodes=2, reject=True, save_bgmeta=True, col_chunk=3,
        device="cpu"))
    m = _np(tmf.valid_mask(torch.from_numpy(_image(infile)[:, :, 350:422])))
    return by, root, m, _image(out + "_bgmeta")[..., 0]


def _chunk_children(by, chunk):
    return sorted((s for v in by.values() for s in v if s.parent_id == chunk.span_id),
                  key=lambda s: s.start_ns)


def test_multimodal_spans_nest_under_the_chunk_and_the_image(small_mode_spans):
    by, root, _, _ = small_mode_spans
    chunks = by["cmf.chunk"]
    assert len(chunks) == 2 and all(c.parent_id == root.span_id for c in chunks)
    for chunk in chunks:
        got = _chunk_children(by, chunk)
        assert [s.name for s in got] == ["cmf.pca", "cmf.kmeans", "cmf.mode", "cmf.mode"]
        for s in got:
            assert chunk.start_ns <= s.start_ns <= s.end_ns <= chunk.end_ns
    assert {k for k, v in by.items() if v[0].parent_id == root.span_id} == {
        "cmf.read", "cmf.h2d", "cmf.chunk", "cmf.stats", "cmf.write"}
    assert "cmf.f64" not in by
    assert all(by[k][0].counts == {} for k in ("cmf.image", "cmf.pca", "cmf.kmeans"))


def test_mode_rows_sum_to_the_columns_valid_counts(small_mode_spans):
    """Each mode's ``rows`` is its labelled valid pixels in the chunk's own
    columns; the modes' rows sum to those columns' valid counts."""
    by, _, m, labels = small_mode_spans
    for chunk, (c0, c1) in zip(by["cmf.chunk"], ((0, 3), (3, 5))):
        modes = [s for s in _chunk_children(by, chunk) if s.name == "cmf.mode"]
        rows = [s.counts["rows"] for s in modes]
        assert sum(rows) == int(m[:, c0:c1].sum())
        assert rows == [int((m[:, c0:c1] & (labels[:, c0:c1] == k)).sum()) for k in (0, 1)]


def test_mode_rejected_counts_the_columns_that_reject_it(small_mode_spans):
    by, _, m, labels = small_mode_spans
    for chunk, (c0, c1) in zip(by["cmf.chunk"], ((0, 3), (3, 5))):
        modes = [s for s in _chunk_children(by, chunk) if s.name == "cmf.mode"]
        want = [sum(int((m[:, c] & (labels[:, c] == k)).sum()) < 85 for c in range(c0, c1))
                for k in (0, 1)]
        assert [s.counts["rejected"] for s in modes] == want
        assert sum(want) == sum(c0 <= c < c1 for c in SMALL_MODE_COLUMNS)


def test_f64_span_counts_the_gated_columns(tmp_path, rng):
    """The f32 gate's recompute is one ``cmf.f64`` span a chunk that needs
    it, under the chunk, counting its columns, with the f64 path's own
    PCA, k-means and mode spans inside it."""
    infile, libf = _two_mode_flightline(tmp_path, rng, rank4=(1, 4))
    got = {}
    by, root = _image_spans(lambda: got.update(tpl.robust_mf_image(
        infile, libf, str(tmp_path / "g"), col_chunk=3, bgmodes=2, pcadim=4,
        dtype=np.float32, device="cpu")))
    f64 = by["cmf.f64"]
    assert got["f64_columns"] >= 2
    assert sum(s.counts["columns"] for s in f64) == got["f64_columns"]
    chunks = {c.span_id for c in by["cmf.chunk"]}
    assert all(s.parent_id in chunks for s in f64)
    for s in f64:
        inner = [t.name for v in by.values() for t in v if t.parent_id == s.span_id]
        assert sorted(inner) == ["cmf.kmeans", "cmf.mode", "cmf.mode", "cmf.pca"]


def test_unimodal_path_adds_only_the_image_span(tmp_path, rng):
    infile, libf, _, _ = _write_flightline(tmp_path, rng, L=64, C=5)
    by, root = _image_spans(lambda: tpl.robust_mf_image(
        infile, libf, str(tmp_path / "u"), col_chunk=3, device="cpu"))
    assert set(by) == {"cmf.image", "cmf.read", "cmf.h2d", "cmf.chunk", "cmf.stats",
                       "cmf.write"}
    assert all(s.parent_id == root.span_id for k, v in by.items() if k != "cmf.image"
               for s in v)
