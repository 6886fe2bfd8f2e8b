"""The port's GoogLeNet and FCN saliency held against the JAX package.

The same Flax variables reach both packages through
srcfinder_torch.models.convert.flax_to_torch_state_dict. Tolerance: atol
1e-5 on features, logits and saliency. Both sides compute in f32 on the
CPU; they differ in convolution algorithm and summation order, and with
the O(1) activations of these inputs that moves values by ~1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcfinder_tpu.detect import fcn_pipeline as jfp
from srcfinder_tpu.detect.cnn_cli import save_weights as jsave_weights
from srcfinder_tpu.models import googlenet as jgooglenet
from srcfinder_tpu.models.googlenet import fold_inference as jfold
from srcfinder_torch.detect import fcn_pipeline as tfp
from srcfinder_torch.models import convert
from srcfinder_torch.models.fcn import fcn_apply
from srcfinder_torch.models.googlenet import GoogLeNet, fold_inference

torch.set_num_threads(1)

ATOL = 1e-5
# the golden's image shape; the live JAX phase-saliency comparisons all use
# it with the folded Flax model, so they share one XLA compile
_IMG_SHAPE = (20, 45)


def _flax_model():
    return jgooglenet(num_classes=2, dropout=0.0, dropout_aux=0.0)


def _flax_init(seed):
    return _flax_model().init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 64, 64, 1)), train=False)


def _to_numpy(tree):
    return jax.tree.map(np.array, jax.device_get(tree))


@pytest.fixture(scope="module")
def init7():
    """Flax init PRNGKey(7) (the fcn_saliency golden's weights); one
    trace of the Flax init serves every test of the module."""
    return _to_numpy(_flax_init(7))


def _rescaled(variables):
    """Conv kernels rescaled to std sqrt(1 / fan_in), so the trunk's
    activations stay O(1) through all five stages (the trunc-normal
    std 0.01 init shrinks them towards 0 and the saliency to 0.5)."""
    v = _to_numpy(variables)
    v["params"] = jax.tree.map(
        lambda a: (a / a.std() * np.sqrt(1.0 / np.prod(a.shape[:3])))
        .astype(np.float32) if a.ndim == 4 else a, v["params"])
    return v


def _trained_like(variables, rng):
    """Rescaled variables with BatchNorm affine and running stats
    perturbed as after training (the zero background is then no fixed
    point of the trunk)."""
    v = _rescaled(variables)

    def walk(p, s):
        for k in p:
            if k == "bn":
                c = p[k]["scale"].shape
                p[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(p[k], dict):
                walk(p[k], s.setdefault(k, {}))
    walk(v["params"], v["batch_stats"])
    return v


def _port_model(variables):
    model = GoogLeNet(num_classes=2)
    model.load_state_dict(convert.flax_to_torch_state_dict(_to_numpy(variables)))
    return model.eval()


def test_weight_conversion_round_trips(init7):
    v = init7
    sd = convert.flax_to_torch_state_dict(v)
    assert sd["conv1.conv.weight"].shape == (64, 1, 7, 7)
    assert sd["inception3a.branch2.1.conv.weight"].shape == (128, 96, 3, 3)
    back = convert.torch_state_dict_to_flax(sd)
    flat_a = {"/".join(map(str, k)): x for k, x in
              jax.tree_util.tree_flatten_with_path(v)[0]}
    flat_b = {"/".join(map(str, k)): x for k, x in
              jax.tree_util.tree_flatten_with_path(back)[0]}
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


def test_load_weights_npz_matches_variables(tmp_path, init7):
    v = init7
    wf = str(tmp_path / "w.npz")
    jsave_weights(wf, v)
    sd = convert.load_weights(wf)
    ref = convert.flax_to_torch_state_dict(_to_numpy(v))
    assert sd.keys() == ref.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    GoogLeNet(num_classes=2).load_state_dict(sd)          # strict


def test_stage_features_and_logits_match_flax(init7):
    """The folded+fused inference trunk, stage by stage, then the logits
    and the FCN head, against Flax's folded+fused model."""
    rng = np.random.default_rng(11)
    fmodel, variables = jfold(_flax_model(), _trained_like(init7, rng))
    tmodel = fold_inference(_port_model(_trained_like(init7, np.random.default_rng(11))))
    assert tmodel.fused and tmodel.folded
    x = rng.normal(0.0, 0.25, size=(2, 64, 96, 1)).astype(np.float32)
    fx, tx = jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for stage in (1, 2, 3, 4, 5):
            fx = fmodel.apply(variables, fx, train=False, stage=stage)
            tx = tmodel(tx, stage=stage)
            ref = np.asarray(fx)
            assert np.abs(ref).max() > 0.1                 # O(1) activations
            np.testing.assert_allclose(tx.permute(0, 2, 3, 1).numpy(), ref,
                                       rtol=1e-4, atol=ATOL,
                                       err_msg=f"stage {stage}")
        logits = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        fcn = fcn_apply(tmodel, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(fmodel.apply(variables, jnp.asarray(x), train=False)),
        rtol=1e-4, atol=ATOL)
    from srcfinder_tpu.models.fcn import fcn_apply as jfcn_apply
    np.testing.assert_allclose(
        fcn, np.asarray(jfcn_apply(fmodel, variables, jnp.asarray(x))),
        rtol=1e-4, atol=ATOL)


def test_fold_inference_matches_canonical_port(init7):
    rng = np.random.default_rng(12)
    tmodel = _port_model(_trained_like(init7, rng))
    x = torch.from_numpy(rng.normal(0.0, 0.25, size=(2, 1, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        for stage in (None, 5):
            a = tmodel(x, features_only=True) if stage else tmodel(x)
            b = fold_inference(tmodel)
            b = b(x, features_only=True) if stage else b(x)
            torch.testing.assert_close(b, a, rtol=1e-4, atol=ATOL)


def test_phase_saliency_matches_golden_and_jax(init7):
    """The golden's case: Flax init PRNGKey(7), a 20x45 image."""
    import os
    variables = init7
    img = np.random.default_rng(12345).normal(size=(20, 45)).astype(np.float32)
    model = fold_inference(_port_model(variables))
    got = tfp.fcn_phase_saliency(model, torch.from_numpy(img)).numpy()
    ref = np.asarray(jfp.fcn_phase_saliency(*jfold(_flax_model(), variables),
                                            jnp.asarray(img)))
    gold = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "fcn_saliency.npz"))["a00"]
    assert got.shape == (20, 45)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, gold, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def trained_band(init7):
    """Trained-like variables, a raw CH4 band with nodata pixels, and the
    JAX package's saliency of it (fcn_saliency_image: preprocessing, then
    the phase path). One JAX run serves the two tests that use it."""
    rng = np.random.default_rng(16)
    variables = _trained_like(init7, rng)
    band = rng.normal(300.0, 400.0, _IMG_SHAPE).astype(np.float32)
    band[0, :5] = -9999.0
    ref = np.asarray(jfp.fcn_saliency_image(band, variables, model=_flax_model()))
    return variables, band, ref


def test_phase_saliency_matches_jax_with_trained_bn(trained_band):
    """Trained-like BatchNorm: a non-constant saliency, nonzero background
    fills at every level, and the phase path's edge behaviour."""
    from srcfinder_torch.detect.preprocess import norm_for_model, preprocess_ch4
    variables, band, ref = trained_band
    img = preprocess_ch4(torch.from_numpy(band), *norm_for_model("multi_64"))
    model = fold_inference(_port_model(variables))
    got = tfp.fcn_phase_saliency(model, img).numpy()
    valid = band != -9999.0                    # nodata is re-stamped in ref
    assert ref[valid].std() > 1e-3                        # not a constant map
    np.testing.assert_allclose(got[valid], ref[valid], rtol=0, atol=ATOL)


def test_phase_equals_shift_in_port(init7):
    """Fresh init (BatchNorm offsets zero): the zero background is a fixed
    point, and the phase path equals the literal 1024-shift oracle, as the
    JAX package asserts for its own pair."""
    model = fold_inference(_port_model(init7))
    img = torch.from_numpy(np.random.default_rng(14).normal(
        size=(8, 8)).astype(np.float32))
    phase = tfp.fcn_phase_saliency(model, img)
    shift = tfp.fcn_shift_saliency(model, img, batch=128)
    torch.testing.assert_close(phase, shift, rtol=0, atol=1e-6)


def test_shift_oracle_matches_jax(init7):
    """The port's per-shift oracle == the JAX package's, on trained-like
    weights whose saliency is far from constant."""
    variables = _trained_like(init7, np.random.default_rng(18))
    img = np.random.default_rng(17).normal(size=(8, 8)).astype(np.float32)
    got = tfp.fcn_shift_saliency(fold_inference(_port_model(variables)),
                                 torch.from_numpy(img), batch=128).numpy()
    ref = np.asarray(jfp.fcn_shift_saliency(_flax_model(), variables,
                                            jnp.asarray(img), 32, 128))
    assert ref.std() > 1e-4
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_stitch_pad_and_phase_orders_match_jax():
    rng = np.random.default_rng(15)
    preds = rng.normal(size=(1024, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tfp.stitch_stack((70, 100), torch.from_numpy(preds)).numpy(),
        np.asarray(jfp.stitch_stack((70, 100), jnp.asarray(preds))))
    img = rng.normal(size=(33, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        tfp.divisibility_pad(torch.from_numpy(img), 32).numpy(),
        np.asarray(jfp.divisibility_pad(jnp.asarray(img), 32)))
    np.testing.assert_array_equal(tfp._phase_order(32), jfp._phase_order(32))
    np.testing.assert_array_equal(tfp._phase_order_wide(32),
                                  jfp._phase_order_wide(32))


def test_fcn_saliency_image_matches_jax(tmp_path, trained_band):
    """Raw CH4 band -> saliency through load_saliency_model (.npz written
    by the JAX package) and fcn_saliency_image; nodata re-stamped."""
    variables, band, ref = trained_band
    wf = str(tmp_path / "w.npz")
    jsave_weights(wf, variables)
    model = tfp.load_saliency_model(wf, device="cpu")
    got = tfp.fcn_saliency_image(band, model, device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == -9999.0, band == -9999.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_fcn_unported_methods_raise():
    model = GoogLeNet(num_classes=2, generator=torch.Generator().manual_seed(0))
    band = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError, match="scale == 32"):
        tfp.fcn_phase_saliency(fold_inference(model), torch.zeros(8, 8), scale=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfp.fcn_saliency_image(band, model)
