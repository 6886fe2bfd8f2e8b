"""The port's other FCN paths held against the JAX package on the CPU: the
halo-blocked phase path, the dilated (a-trous) trunk and saliency, the
bf16 trunk, scene batching, the scan layout, the routing of
fcn_saliency_image and the fcn_cli entry point.

Both packages get the same Flax variables: the port's GoogLeNet init as a
Flax tree (numpy), made "trained-like" by tests/test_torch_fcn.py's
``_trained_like`` (conv std sqrt(1 / fan_in), BatchNorm perturbed), so
activations stay O(1) and the zero background is no fixed point of the
trunk. Tolerances: atol 1e-5 in f32 (convolution algorithm and summation
order, ~1e-6 at these activations); 2e-2 for bf16 and for the edge
caveats the JAX package bounds at 2e-2 (tests/test_detect.py).

The blocked cases need the real TRUNK_HALO (448 lines) and so two
1,824-line windows, the windowed dilated case two 1,856-line windows;
their port side runs with a few threads (``_threads``) to bound the
file's wall time.
"""

import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcfinder_tpu.detect import fcn_cli as jfcn_cli
from srcfinder_tpu.detect import fcn_pipeline as jfp
from srcfinder_tpu.detect.cnn_cli import save_weights as jsave_weights
from srcfinder_tpu.models import googlenet as jgooglenet
from srcfinder_tpu.models.googlenet import fold_inference as jfold
from srcfinder_torch.core.envi import open_envi, save_envi
from srcfinder_torch.detect import fcn_cli
from srcfinder_torch.detect import fcn_pipeline as tfp
from srcfinder_torch.models import convert
from srcfinder_torch.models.googlenet import GoogLeNet, fold_inference
from tests.test_torch_fcn import _port_model, _trained_like

torch.set_num_threads(1)

ATOL = 1e-5
BF16_TOL = 2e-2
HALO = tfp.TRUNK_HALO
BLOCK = 928                    # two windows of 928 + 2 * 448 lines


@contextmanager
def _threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _flax_model(dtype=jnp.float32):
    return jgooglenet(num_classes=2, dropout=0.0, dropout_aux=0.0, dtype=dtype)


@pytest.fixture(scope="module")
def fresh():
    """Init-time variables (BatchNorm identity, std 0.01 kernels) as a
    Flax tree."""
    gen = torch.Generator().manual_seed(7)
    return convert.torch_state_dict_to_flax(GoogLeNet(num_classes=2, generator=gen).state_dict())


@pytest.fixture(scope="module")
def trained(fresh):
    """(Flax variables, JAX folded model and variables, the port's folded
    model), trained-like."""
    v = _trained_like(fresh, np.random.default_rng(5))
    fmodel, fvars = jfold(_flax_model(), v)
    return v, fmodel, fvars, fold_inference(_port_model(v))


def _img(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def blocked_on_grid(trained):
    """2 x 928 lines (on the 32-line grid) x 17: the port's blocked and
    unblocked passes and the JAX package's blocked pass."""
    v, fmodel, fvars, model = trained
    img = _img((2 * BLOCK, 17), 21)
    with _threads(4):
        blocked = tfp.fcn_phase_saliency_blocked(model, torch.from_numpy(img),
                                                 block=BLOCK).numpy()
        unblocked = tfp.fcn_phase_saliency(model, torch.from_numpy(img)).numpy()
    ref = np.asarray(jfp.fcn_phase_saliency_blocked(fmodel, fvars, jnp.asarray(img),
                                                    block=BLOCK, halo=HALO))
    return blocked, unblocked, ref


def test_blocked_matches_unblocked_on_grid(blocked_on_grid):
    blocked, unblocked, _ = blocked_on_grid
    assert blocked.shape == (2 * BLOCK, 17)
    assert unblocked.std() > 1e-3                     # not a constant map
    np.testing.assert_allclose(blocked, unblocked, rtol=0, atol=ATOL)


def test_blocked_matches_jax_on_grid(blocked_on_grid):
    blocked, _, ref = blocked_on_grid
    np.testing.assert_allclose(blocked, ref, rtol=0, atol=ATOL)


def test_blocked_off_grid_pre_pad(trained):
    """A line count off the 32-line grid: the scene is padded to it first,
    so rows above the bottom halo equal the unblocked pass (the JAX
    package's, on the same variables) and the bottom halo carries the
    phase path's edge caveat; the whole map equals the JAX package's
    blocked pass."""
    v, fmodel, fvars, model = trained
    img = _img((2 * BLOCK - 6, 17), 22)
    with _threads(4):
        got = tfp.fcn_phase_saliency_blocked(model, torch.from_numpy(img),
                                             block=BLOCK).numpy()
    unblocked = np.asarray(jfp.fcn_phase_saliency(fmodel, fvars, jnp.asarray(img)))
    assert got.shape == unblocked.shape
    np.testing.assert_allclose(got[:-HALO], unblocked[:-HALO], rtol=0, atol=ATOL)
    assert np.abs(got[-HALO:] - unblocked[-HALO:]).max() < 2e-2
    ref = np.asarray(jfp.fcn_phase_saliency_blocked(fmodel, fvars, jnp.asarray(img),
                                                    block=BLOCK, halo=HALO))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("width", [333, 598, 669, 1024, 1500, 4096])
def test_auto_block_matches_jax(width):
    got = tfp._auto_block(width, 32)
    assert got == jfp._auto_block(width, jfp.TRUNK_HALO, 32)
    assert got % 32 == 0
    if width == 598:                     # the port's chip flightline width
        assert (got, got + 2 * HALO) == (4928, 5824)


def test_blocking_constants_match_jax():
    assert (tfp.MAX_UNBLOCKED_LINES, tfp.MAX_UNBLOCKED_PX, tfp.WINDOW_BUDGET_PX,
            tfp.TRUNK_HALO) == (jfp.MAX_UNBLOCKED_LINES, jfp.MAX_UNBLOCKED_PX,
                                jfp.WINDOW_BUDGET_PX, jfp.TRUNK_HALO)


def test_short_scene_falls_back_bit_identical(trained):
    model = trained[3]
    img = torch.from_numpy(_img((20, 45), 23))
    torch.testing.assert_close(tfp.fcn_phase_saliency_blocked(model, img),
                               tfp.fcn_phase_saliency(model, img), rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiple of scale"):
        tfp.fcn_phase_saliency_blocked(model, img, block=100)


def test_dilated_windows_over_budget(trained, monkeypatch):
    """A scene whose canvas (1,888 x 96) exceeds a lowered DILATED_WINDOW_PX
    runs as line windows, two of 1,856 canvas lines with the real 448-line
    halo, and equals the whole-canvas pass and the JAX package's dilated
    fcn_saliency_image."""
    v, fmodel, fvars, model = trained
    band = np.random.default_rng(32).normal(300.0, 400.0, (1800, 17)).astype(np.float32)
    band[0, :4] = -9999.0
    with _threads(4):
        whole = tfp.fcn_saliency_image(band, model, method="dilated", device="cpu").numpy()
        windows = []
        real = tfp._dilated_probs
        monkeypatch.setattr(tfp, "_dilated_probs",
                            lambda m, c: windows.append(tuple(c.shape)) or real(m, c))
        monkeypatch.setattr(tfp, "DILATED_WINDOW_PX", 1856 * 96)
        got = tfp.fcn_saliency_image(band, model, method="dilated", device="cpu").numpy()
    assert windows == [(1856, 96)] * 2
    ref = np.asarray(jfp.fcn_saliency_image(band, v, model=_flax_model(), method="dilated"))
    assert whole.std() > 1e-3
    np.testing.assert_array_equal(got == -9999.0, band == -9999.0)
    np.testing.assert_allclose(got, whole, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_dilated_block_sizes_and_short_scene(trained):
    """The default blocks: the fewest windows within the budget, balanced
    on the 32-line grid; a canvas no longer than one window runs one pass
    whatever ``block`` says; a block off the grid raises."""
    assert tfp._dilated_block(12096, 672, 32) == 2432      # 12,000 x 598: 5 windows
    assert tfp._dilated_block(4032, 672, 32) == 2016       # 2 windows of 2,912 lines
    model = trained[3]
    img = torch.from_numpy(_img((20, 45), 33))
    torch.testing.assert_close(tfp.fcn_dilated_saliency(model, img, block=32),
                               tfp.fcn_dilated_saliency(model, img), rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiple of scale"):
        tfp.fcn_dilated_saliency(model, img, block=100)


def test_dilated_trunk_features_match_jax(trained):
    v, fmodel, fvars, model = trained
    x = np.random.default_rng(24).normal(0.0, 0.25, (1, 40, 48, 1)).astype(np.float32)
    ref = np.asarray(fmodel.apply(fvars, jnp.asarray(x), train=False, dilated=True))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), dilated=True)
    assert got.shape == (1, 1024, 40, 48)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=ATOL)


def test_dilated_saliency_matches_jax(trained):
    v, fmodel, fvars, model = trained
    img = _img((20, 45), 25)
    got = tfp.fcn_dilated_saliency(model, torch.from_numpy(img)).numpy()
    ref = np.asarray(jfp.fcn_dilated_saliency(fmodel, fvars, jnp.asarray(img)))
    assert got.shape == (20, 45) and ref.std() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # with trained BatchNorm the dilated path's edge caveat, bounded
    phase = tfp.fcn_phase_saliency(model, torch.from_numpy(img)).numpy()
    assert np.abs(got - phase).max() < BF16_TOL


def test_dilated_equals_shift_at_fresh_init(fresh):
    """At init the zero background is a fixed point: the dilated pass is
    bit-exact against the literal per-shift path (tests/test_detect.py's
    test_fcn_dilated_saliency_bitexact, for the port)."""
    model = fold_inference(_port_model(fresh))
    img = torch.from_numpy(_img((8, 12), 26))
    torch.testing.assert_close(tfp.fcn_dilated_saliency(model, img),
                               tfp.fcn_shift_saliency(model, img, batch=256),
                               rtol=0, atol=0)


def test_bf16_trunk_close_to_f32_and_jax(trained):
    v, fmodel, fvars, model = trained
    img = _img((20, 45), 27)
    bf16 = tfp.saliency_model(convert.flax_to_torch_state_dict(v), torch.bfloat16, "cpu")
    assert next(bf16.parameters()).dtype == torch.bfloat16
    with torch.no_grad():
        assert bf16(torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16), stage=1).dtype \
            == torch.bfloat16
    got = tfp.fcn_phase_saliency(bf16, torch.from_numpy(img).bfloat16()).float().numpy()
    f32 = tfp.fcn_phase_saliency(model, torch.from_numpy(img)).numpy()
    jmodel, jvars = jfold(_flax_model(jnp.bfloat16), v)
    ref = np.asarray(jfp.fcn_phase_saliency(jmodel, jvars, jnp.asarray(img, jnp.bfloat16))
                     .astype(jnp.float32))
    assert f32.std() > 1e-3
    assert np.abs(got - f32).max() < BF16_TOL
    assert np.abs(got - ref).max() < BF16_TOL


def test_scene_batch_matches_single_and_jax(trained):
    """Two scenes through one pass: each scene's map is its single-scene
    map, and the JAX package's batch."""
    v, fmodel, fvars, model = trained
    imgs = np.stack([_img((20, 45), 28), _img((20, 45), 29)])
    got = tfp.fcn_phase_saliency_batch(model, torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 20, 45)
    for i in range(2):
        single = tfp.fcn_phase_saliency(model, torch.from_numpy(imgs[i])).numpy()
        np.testing.assert_allclose(got[i], single, rtol=0, atol=1e-6)
    ref = np.asarray(jfp.fcn_phase_saliency_batch(fmodel, fvars, jnp.asarray(imgs)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_scan_layout_matches_wide(trained):
    model = trained[3]
    img = torch.from_numpy(_img((52, 45), 30))
    wide = tfp.fcn_phase_saliency(model, img)
    scan = tfp.fcn_phase_saliency(model, img, layout="scan")
    assert wide.std() > 1e-3
    torch.testing.assert_close(scan, wide, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        tfp.fcn_phase_saliency(model, img, layout="tall")


def test_fcn_saliency_image_routes_like_jax(trained, monkeypatch):
    """'auto' takes the blocked path past the line or pixel ceiling (with
    the JAX package's environment overrides), 'phase-blocked' and
    'dilated' run, and each equals the JAX package's fcn_saliency_image."""
    v, fmodel, fvars, model = trained
    band = np.random.default_rng(31).normal(300.0, 400.0, (20, 45)).astype(np.float32)
    band[0, :4] = -9999.0
    calls = []
    real = tfp.fcn_phase_saliency_blocked
    monkeypatch.setattr(tfp, "fcn_phase_saliency_blocked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for env, method in ((None, "phase-blocked"), (("SRCFINDER_FCN_MAX_LINES", "19"), "auto"),
                        (("SRCFINDER_FCN_MAX_PX", "899"), "auto"), (None, "dilated")):
        if env:
            monkeypatch.setenv(*env)
        got = tfp.fcn_saliency_image(band, model, method=method, device="cpu").numpy()
        ref = np.asarray(jfp.fcn_saliency_image(band, v, model=_flax_model(), method=method))
        np.testing.assert_array_equal(got == -9999.0, band == -9999.0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        if env:
            monkeypatch.delenv(env[0])
    assert len(calls) == 3


@pytest.mark.parametrize("max_px", [None, "500"])
def test_fcn_cli_two_bands_match_fcn_saliency_image(tmp_path, trained, monkeypatch,
                                                    max_px):
    """Two CMF bands through fcn_cli.main: one scene batch, or (pixel
    budget 500) scene by scene through the blocked path; each product
    equals fcn_saliency_image's, and the batch's the JAX CLI's."""
    v = trained[0]
    wf = str(tmp_path / "w.npz")
    jsave_weights(wf, v)
    paths = []
    for i in range(2):
        band = np.abs(np.random.default_rng(40 + i).normal(size=(20, 45))
                      ).astype(np.float32) * 300
        band[0, i] = -9999.0
        pth = str(tmp_path / f"ang2020010{i}t000000_cmf_v2y1_img")
        save_envi(pth + ".hdr", band[..., None], metadata={"data ignore value": -9999},
                  interleave="bip")
        paths.append(pth)
    if max_px:
        monkeypatch.setenv("SRCFINDER_FCN_MAX_PX", max_px)
    out = str(tmp_path / "out")
    assert fcn_cli.main(paths + ["-m", "multi_64", "-w", wf, "-o", out,
                                 "--device", "cpu"]) == 0
    if max_px:
        monkeypatch.delenv("SRCFINDER_FCN_MAX_PX")
    else:
        jout = str(tmp_path / "jax")
        assert jfcn_cli.main(paths + ["-m", "multi_64", "-w", wf, "-o", jout]) == 0
    model = tfp.load_saliency_model(wf, device="cpu")
    for pth in paths:
        name = os.path.basename(pth) + "_saliency"
        got = open_envi(os.path.join(out, name)).load()[..., 0]
        band = open_envi(pth).load()[..., 0]
        ref = tfp.fcn_saliency_image(band, model, device="cpu").numpy()
        np.testing.assert_array_equal(got == -9999.0, band == -9999.0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        if not max_px:
            np.testing.assert_allclose(
                got, open_envi(os.path.join(jout, name)).load()[..., 0], rtol=0, atol=ATOL)
    if max_px:
        return
    # one flightline: the single-scene path with --method
    one = str(tmp_path / "one")
    assert fcn_cli.main([paths[0], "-m", "multi_64", "-w", wf, "-o", one,
                         "--method", "dilated", "--device", "cpu"]) == 0
    name = os.path.basename(paths[0]) + "_saliency"
    band = open_envi(paths[0]).load()[..., 0]
    np.testing.assert_allclose(
        open_envi(os.path.join(one, name)).load()[..., 0],
        tfp.fcn_saliency_image(band, model, method="dilated", device="cpu").numpy(),
        rtol=0, atol=0)
    assert fcn_cli.main(paths + ["-w", wf, "-o", one, "--method", "dilated",
                                 "--device", "cpu"]) == 2
