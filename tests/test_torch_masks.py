"""The port's spectrometer masks (srcfinder_torch.masks) held against the
JAX package's on the CPU.

The masks are boolean tests and integer morphology, so every comparison
is exact: the per-pixel tests compare the same f32 values against the
same f32 thresholds in both packages.
"""

import os

import numpy as np
import pytest
import torch

import jax

from srcfinder_tpu.core import envi as jenvi
from srcfinder_tpu.masks import cli as jcli
from srcfinder_tpu.masks import sds as jsds
from srcfinder_torch.core.envi import open_envi
from srcfinder_torch.masks import cli as tcli
from srcfinder_torch.masks import sds as tsds

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "masks.npz")
# the JAX package's small synthetic band layout (tests/test_masks.py):
# cloud bands 0-2, dark 3, specular 4, saturation window 5-7
WL8 = np.array([450., 670., 1250., 2139., 500., 2000., 2200., 2400.], np.float32)
META = {"data ignore value": -9999,
        "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1",
                     "11", "North", "WGS-84", "units=Meters", "rotation=0"]}


def _params(**kw):
    return (tsds.MaskParams(cld_bands=(0, 1, 2), dark_band=3, spec_band=4, **kw),
            jsds.MaskParams(cld_bands=(0, 1, 2), dark_band=3, spec_band=4, **kw))


def _edge_block(seed):
    """A seeded (24, 16, 8) block with values exactly at the thresholds
    (6.0, 15.0, 9.0 and f32(0.104)), one f32 step either side of them,
    -9999 pixels and rows, and cloud slopes whose f32 differences are one
    step or zero."""
    rng = np.random.default_rng(seed)
    blk = rng.uniform(0.0, 20.0, (24, 16, 8)).astype(np.float32)
    f32 = np.float32

    def around(v):
        v = f32(v)
        return np.array([np.nextafter(v, f32(-np.inf)), v, np.nextafter(v, f32(np.inf))],
                        np.float32)
    pick = rng.integers(0, 3, (24, 16))
    blk[..., 6] = np.where(rng.random((24, 16)) < 0.5, around(6.0)[pick], blk[..., 6])
    blk[..., 0] = np.where(rng.random((24, 16)) < 0.5, around(15.0)[pick], blk[..., 0])
    blk[..., 4] = np.where(rng.random((24, 16)) < 0.5, around(9.0)[pick], blk[..., 4])
    blk[..., 3] = np.where(rng.random((24, 16)) < 0.5, around(0.104)[pick], blk[..., 3])
    # slopes: rdn2 one f32 step below, equal to, or above rdn1
    blk[::3, :, 1] = np.nextafter(blk[::3, :, 0], f32(-np.inf))
    blk[1::3, :, 1] = blk[1::3, :, 0]
    blk[2::3, :, 2] = np.nextafter(blk[2::3, :, 1], f32(np.inf))
    blk[5, 3] = -9999.0
    blk[7:9, :, 3] = -9999.0
    blk[-2:] = -9999.0                     # the last block's padding rows
    return blk


@pytest.mark.parametrize("seed,two_slope", [(0, True), (1, True), (2, False)])
def test_pixel_masks_match_jax_at_thresholds(seed, two_slope):
    tparams, jparams = _params(two_slope=two_slope)
    blk = _edge_block(seed)
    got = tsds.pixel_masks(torch.from_numpy(blk), torch.from_numpy(WL8), tparams)
    ref = jsds.pixel_masks(blk, WL8, jparams)
    for name, g, r in zip(("saturated", "cloud", "spec", "dark"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        assert 0 < g.sum() < g.numel(), name           # both outcomes occur
    # the -9999 padding rows trip no test
    assert not any(g[-2:].any() for g in got)


def test_needed_bands_and_compact_params_match_jax():
    wl = np.linspace(380, 2500, 425)
    for tp, jp in (_params(), (tsds.MaskParams(), jsds.MaskParams())):
        for w in (WL8, wl):
            if max(tp.dark_band, tp.spec_band, *tp.cld_bands) >= len(w):
                continue
            need = tsds.needed_bands(w, tp)
            np.testing.assert_array_equal(need, jsds.needed_bands(w, jp))
            assert tuple(tsds._compact_params(tp, need)) == tuple(
                jsds._compact_params(jp, need))


@pytest.mark.parametrize("value,meta", [
    ("10px", {}), ("7.2px", {}), ("150m", META),
    ("150m", {"map info": META["map info"][:5] + ["3.0", "3.5"] + META["map info"][7:]}),
    ("150m", {}), ("150m", {"map info": META["map info"][:10] + ["units=Feet"]}),
    ("150", META)])
def test_get_radius_in_pixels_matches_jax(value, meta):
    try:
        want = jsds.get_radius_in_pixels(value, meta)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match=str(e)):
            tsds.get_radius_in_pixels(value, meta)
    else:
        assert tsds.get_radius_in_pixels(value, meta) == want


def _cube(seed, nrows=53, ncols=24):
    """A seeded 8-band cube with every mask class, regions across block
    boundaries and nodata pixels."""
    rng = np.random.default_rng(seed)
    cube = np.abs(rng.normal(1.0, 0.5, (nrows, ncols, 8))).astype(np.float32)
    cube[14:19, 5:9, 6] = 7.5          # saturated region across rows 16/17
    cube[30, 20, 6] = 7.5              # a single saturated pixel (not grown)
    cube[12, 12, 4] = 10.5
    cube[12, 12, 6] = 7.5              # specular
    cube[40:42, 2:4, 6] = 7.5
    cube[40:42, 2:4, 4] = 9.5          # saturated and vetoed from growing
    cube[20:23, 3:6, 3] = 0.05         # dark
    cube[31:34, 10:12, 0] = 20.0       # cloud (falling slopes)
    cube[31:34, 10:12, 1] = 5.0
    cube[31:34, 10:12, 2] = 2.0
    cube[0, 0] = -9999.0
    cube[-1, 5:9] = -9999.0
    return cube


def test_masks_for_cube_matches_golden_and_jax():
    """The golden's case (tests/test_goldens.py::_masks_case), and a
    second cube with regions across block boundaries, against the JAX
    package."""
    tparams, jparams = _params()
    rng = np.random.default_rng(12345)
    cube = np.abs(rng.normal(1.0, 0.5, (48, 24, 8))).astype(np.float32)
    cube[5:9, 5:9, 6] = 7.5
    cube[12, 12, 4] = 10.5
    cube[12, 12, 6] = 7.5
    cube[20:23, 3:6, 3] = 0.05
    cube[30:33, 10:12, 0] = 20.0
    cube[30:33, 10:12, 1] = 5.0
    cube[30:33, 10:12, 2] = 2.0
    cube[0, 0] = -9999.0
    got = tsds.masks_for_cube(lambda r0, r1: cube[r0:r1], 48, 24, WL8, params=tparams,
                              maskgrowradius_px=3.0, mingrowarea=5, cldbfr_px=2.0,
                              block_step=16, nodata_row0=cube[..., 0] == -9999.0,
                              device="cpu")
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, np.load(GOLDEN)["a00"])

    cube = _cube(7)
    kw = dict(maskgrowradius_px=2.0, mingrowarea=3, cldbfr_px=1.0, block_step=16,
              nodata_row0=cube[..., 0] == -9999.0)
    got = tsds.masks_for_cube(
        read_block_bands=lambda r0, r1, b: cube[r0:r1][:, :, b], nrows=53, ncols=24,
        wavelengths=WL8, params=tparams, device="cpu", **kw)
    ref = jsds.masks_for_cube(lambda r0, r1: cube[r0:r1], 53, 24, WL8, params=jparams,
                              device=jax.devices("cpu")[0], **kw)
    np.testing.assert_array_equal(got, ref)
    for band in range(4):
        assert (got[..., band] > 0).any(), band


def _radiance(d, name, seed=3, nrows=60, ncols=16, nb=425):
    """An AVIRIS-NG-shaped BIL radiance with a saturated patch, a specular
    one, a cloud and a dark patch at the bands the header's wavelengths
    resolve to, and nodata pixels."""
    rng = np.random.default_rng(seed)
    wl = np.linspace(380, 2500, nb)
    cube = np.abs(rng.normal(2.7, 0.3, (nrows, ncols, nb))).astype(np.float32)

    def band(nm):
        return int(np.argmin(np.abs(wl - nm)))
    sat = slice(band(1945.0), band(2000.0))
    cube[10:14, 3:7, sat] = 8.0
    cube[30:32, 10:12, sat] = 8.0
    cube[30:32, 10:12, band(505.0)] = 12.0
    cube[44:47, 2:5, band(450.0)] = 20.0
    cube[44:47, 2:5, band(670.0)] = 10.0
    cube[44:47, 2:5, band(1250.0)] = 5.0
    cube[50:53, 12:15, band(2139.0)] = 0.05
    cube[0, :2] = -9999.0
    meta = dict(META, wavelength=[f"{w:.2f}" for w in wl])
    path = os.path.join(d, name)
    jenvi.save_envi(path + ".hdr", cube, metadata=meta, interleave="bil")
    return path, cube


@pytest.mark.parametrize("radius", ["2px", None])
def test_masks_for_flightline_matches_jax_and_taps_every_line(tmp_path, radius):
    """The port's masks_for_flightline (tests on the CPU) against the JAX
    package's, and its tap: every block the tap sees holds the file's
    bands at the positions ``pos`` gives, every line is seen, and without
    the growth overlap each line exactly once."""
    rdn, cube = _radiance(str(tmp_path), "ang20200924t211102_rdn_v2y1_img")
    kw = dict(maskgrowradius=radius, mingrowarea=3 if radius else None,
              cldbfr="1px", block_step=16)
    seen = np.zeros(cube.shape[0], int)
    taps = list(range(350, 422)) + [60, 42, 24]

    def tap(r0, r1, blk, pos):
        seen[r0:r1] += 1
        np.testing.assert_array_equal(blk[:, :, [pos[b] for b in taps]],
                                      cube[r0:r1][:, :, taps])
    name = tcli.masks_for_flightline(rdn + ".hdr", str(tmp_path), out_name="port",
                                     tap=tap, tap_bands=taps, device="cpu", **kw)
    jcli.masks_for_flightline(rdn + ".hdr", str(tmp_path), out_name="jax",
                              device=jax.devices("cpu")[0], **kw)
    got = open_envi(os.path.join(str(tmp_path), name)).load()
    ref = open_envi(os.path.join(str(tmp_path), "jax")).load()
    np.testing.assert_array_equal(got, ref)
    assert (got[0, :2] == -9999).all()
    for band in (0, 1, 2, 3) if radius else (0, 1, 3):    # no growth radius: no flare
        assert (got[..., band] > 0).any(), band
    assert (seen >= 1).all()
    if radius is None:
        assert (seen == 1).all()


def test_masks_cli_matches_jax_cli(tmp_path):
    name = "ang20200924t211102_rdn_v2y1_img"
    _radiance(str(tmp_path), name, seed=4)
    txt = tmp_path / "files.txt"
    txt.write_text(name + "\n")
    outs = {}
    for tag, cli in (("port", tcli), ("jax", jcli)):
        out = tmp_path / tag
        os.makedirs(out)
        assert cli.main(["--txt", str(txt), "--inpath", str(tmp_path),
                         "--outpath", str(out), "-M", "2px", "-A", "3", "-B", "1px",
                         "--device", "cpu"]) == 0
        outs[tag] = open_envi(str(out / tcli.mask_output_name(name))).load()
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    assert outs["port"].shape == (60, 16, 4)
    # an existing product is kept without --overwrite
    assert tcli.main(["--txt", str(txt), "--inpath", str(tmp_path), "--outpath",
                      str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert tcli.mask_output_name(name) == jcli.mask_output_name(name)


def test_block_prefetcher_order_errors_and_early_exit():
    """The masks' block reader: blocks arrive in order, a read error is
    raised in the consumer, and leaving the loop early stops the reader
    thread."""
    import threading
    from srcfinder_torch.core.prefetch import BlockPrefetcher
    got = [(i, b.tolist()) for i, b in BlockPrefetcher(lambda i: np.full(3, i), 5)]
    assert got == [(i, [i] * 3) for i in range(5)]

    def bad(i):
        if i == 2:
            raise OSError("read failed")
        return np.zeros(1)
    with pytest.raises(OSError, match="read failed"):
        for _ in BlockPrefetcher(bad, 4):
            pass
    before = threading.active_count()
    for i, _ in BlockPrefetcher(lambda i: np.zeros(1), 100):
        if i == 1:
            break
    assert threading.active_count() == before
