"""The port's detection post-processing (``srcfinder_torch.detect.filtdet``,
``detect.posthoc_down``, ``detect.downsample_cli``, ``core.warp`` and what
they need of ``core.geo`` and ``core.morphology``) held against the JAX
package on the CPU.

Tolerances: the KDE-weighted image and the downsampled raster within 1e-5
of the reference's largest magnitude (both sides blur in f32 and differ
in summation order: the KDE by a conv1d against XLA's convolution, the
downsampling by two FFT libraries); component labels, nodata cells, warps
and relabelings exactly.
"""

import importlib

import numpy as np
import pytest

from srcfinder_tpu.core import envi as jenvi
from srcfinder_tpu.core import geo as jgeo
from srcfinder_tpu.core import morphology as jmorph
from srcfinder_tpu.core import warp as jwarp
from srcfinder_torch.core import envi as tenvi
from srcfinder_torch.core import geo as tgeo
from srcfinder_torch.core import morphology as tmorph
from srcfinder_torch.core import warp as twarp
from srcfinder_torch.detect import downsample_cli as tdown_cli

jfilt = importlib.import_module("srcfinder_tpu.detect.filtdet")
jdown = importlib.import_module("srcfinder_tpu.detect.posthoc_down")
jdown_cli = importlib.import_module("srcfinder_tpu.detect.downsample_cli")
tfilt = importlib.import_module("srcfinder_torch.detect.filtdet")
tdown = importlib.import_module("srcfinder_torch.detect.posthoc_down")

TOL = 1e-5


def _scene(shape, seed):
    """A CMF-like ppm*m map: noise, a strong 6 x 5 plume, a weak lone
    pixel, a strong 2 x 2 blob (dropped as small, re-added as strong) and
    a nodata corner."""
    rng = np.random.default_rng(seed)
    img = rng.normal(200, 250, shape).astype(np.float32)
    h, w = shape
    img[h // 4:h // 4 + 6, w // 4:w // 4 + 5] += 1800
    img[h // 2, w // 2] = 700
    img[h - 4:h - 2, 2:4] = 3000
    nodata = np.zeros(shape, bool)
    nodata[0, :3] = True
    img[nodata] = -9999
    return img, nodata


def _close(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("shape,k", [((160, 90), 50), ((37, 23), 50), ((64, 80), 5),
                                     ((9, 120), 7)])
def test_kde_and_filtdet_match_jax(shape, k):
    """kde and filtdet at the reference constants (k = 50: radius 50, so a
    37 x 23 map folds its symmetric pad several times, as jnp.pad's
    'symmetric' does) and at small k: the KDE within TOL, detkde (the KDE
    over mfmax - mfmin, clipped) within TOL of the KDE's maximum over
    mfmax - mfmin, detcomp equal."""
    img, nodata = _scene(shape, sum(shape) + k)
    ref = np.asarray(jfilt.kde(img, k=k))
    _close(tfilt.kde(img, k=k, device="cpu").numpy(), ref)
    tk, tc = tfilt.filtdet(img, nodata, k=k, device="cpu")
    jk, jc = jfilt.filtdet(img, nodata, k=k)
    # detkde is the KDE rescaled by 1 / (mfmax - mfmin): the same bound
    assert np.abs(tk - jk).max() <= TOL * np.abs(ref).max() / (tfilt.MFMAX - tfilt.MFMIN)
    np.testing.assert_array_equal(tc, jc)
    assert tc.max() > 0


@pytest.mark.parametrize("radius", [1, 3, 50])
def test_symmetric_fold_matches_numpy(radius):
    """The pad index of the separable blur equals numpy's 'symmetric' pad,
    also when the pad is longer than the axis."""
    for n in (1, 2, 5, 37):
        x = np.arange(n)
        idx = tfilt._symmetric_index(n, radius, "cpu").numpy()
        np.testing.assert_array_equal(x[idx], np.pad(x, radius, mode="symmetric"))


@pytest.mark.parametrize("shape,src_res", [((60, 90), 5.0), ((61, 97), 3.1),
                                           ((33, 17), 7.3), ((128, 40), 30.0)])
def test_gaussian_downsample_matches_jax(shape, src_res):
    """gaussian_downsample with nodata cells and odd shapes: the same output
    shape, nodata cells equal, values within TOL."""
    rng = np.random.default_rng(shape[0])
    data = np.abs(rng.normal(100, 30, shape)).astype(np.float32)
    data[:4, :6] = -9999.0
    data[shape[0] // 2, shape[1] // 3] = -9999.0
    got = tdown.gaussian_downsample(data, src_res, 30.0, device="cpu").numpy()
    ref = np.asarray(jdown.gaussian_downsample(data, src_res, 30.0))
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got == -9999.0, ref == -9999.0)
    valid = ref != -9999.0
    assert np.abs(got[valid] - ref[valid]).max() <= TOL * np.abs(ref[valid]).max()
    np.testing.assert_allclose(tdown.gkern(7, 1.3).numpy(), np.asarray(jdown.gkern(7, 1.3)),
                               rtol=1e-6)
    assert tdown.get_pixsig(src_res, 30.0) == jdown.get_pixsig(src_res, 30.0)


def _mapinfo(rotation):
    return ["UTM", "1", "1", "391000", "3786000", "5.0", "5.0", "11", "North",
            "WGS-84", "units=Meters", f"rotation={rotation}"]


@pytest.mark.parametrize("rotation", [0, 12.5])
def test_downsample_cli_matches_jax(tmp_path, rotation, monkeypatch):
    """The downsampling CLI on a UTM band with and without rotation (then
    warped north-up first): the product within TOL of the JAX CLI's, its
    nodata cells and header map info equal."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache")
    rng = np.random.default_rng(int(rotation * 10) + 1)
    data = np.abs(rng.normal(300, 80, (70, 95))).astype(np.float32)
    data[:3, :3] = -9999
    meta = {"data ignore value": -9999, "map info": _mapinfo(rotation)}
    src = str(tmp_path / "src")
    jenvi.save_envi(src + ".hdr", data, metadata=meta, interleave="bip")
    outs = {}
    for name, main in (("jax", jdown_cli.main), ("torch", tdown_cli.main)):
        dst = str(tmp_path / name)
        argv = [src, dst, "-r", "30"] + (["--device", "cpu"] if name == "torch" else [])
        assert main(argv) == 0
        outs[name] = tenvi.open_envi(dst)
    got, ref = outs["torch"].load(), outs["jax"].load()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got == -9999, ref == -9999)
    valid = ref != -9999
    assert np.abs(got[valid] - ref[valid]).max() <= TOL * np.abs(ref[valid]).max()
    assert outs["torch"].metadata["map info"] == outs["jax"].metadata["map info"]
    assert tgeo.mapinfo(outs["torch"])["xps"] == 30.0


def test_warp_geo_and_relabel_match_jax():
    """warp_north_up on a rotated raster (one band and three), xy2sl,
    utmzone2epsg and relabel_sequential equal the JAX package's."""
    rng = np.random.default_rng(3)
    m = tgeo.mapinfo({"map info": _mapinfo(20.0)})
    for data in (rng.normal(size=(30, 41)).astype(np.float32),
                 rng.normal(size=(30, 41, 3)).astype(np.float32)):
        got, gm = twarp.warp_north_up(data, m, nodata=-9999.0)
        ref, rm = jwarp.warp_north_up(data, jgeo.mapinfo({"map info": _mapinfo(20.0)}),
                                      nodata=-9999.0)
        np.testing.assert_array_equal(got, ref)
        assert dict(gm) == dict(rm)
    x, y = rng.uniform(391000, 391200, 50), rng.uniform(3785800, 3786000, 50)
    for a, b in zip(tgeo.xy2sl(x, y, mapinfo=m), jgeo.xy2sl(x, y, mapinfo=m)):
        np.testing.assert_array_equal(a, b)
    assert tgeo.utmzone2epsg(11, "N") == jgeo.utmzone2epsg(11, "N") == 32611
    lab = rng.integers(0, 4, (20, 20)) * 7
    for a, b in zip(tmorph.relabel_sequential(lab), jmorph.relabel_sequential(lab)):
        np.testing.assert_array_equal(a, b)
