"""The port's multi-device inference (``srcfinder_torch.parallel``, the FCN's
and the exact CNN's ``mesh`` paths) held against its own single-device
calls and against the JAX package's sharded calls, on the CPU.

The port's mesh is ``["cpu"] * 8``, the counterpart of the JAX tests'
8 virtual CPU devices (tests/conftest.py); the JAX side runs on that
8-device mesh as its own tests run it. Shards run in threads of one
process, and their results are gathered in order.

Bounds, as the JAX package's own sharded tests state them: the CMF within
rtol 2e-4, atol 1e-6 of JAX (unimodal, f32) and rtol 1e-4, atol 1e-5
(multimodal, f32), alpha indices and labels equal; the FCN within rtol
1e-5, atol 1e-6; the exact CNN equal bit for bit to the port's
single-device call and within 1e-5 of JAX's. Against the port's
single-device call the CMF is held within rtol 1e-6, atol 1e-6 (a
shard's batched products may sum in another order; f32 values of O(1))
with alpha indices, counts and labels equal,
the FCN within rtol 1e-5, atol 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcfinder_tpu.cmf import kmeans as jkm
from srcfinder_tpu.cmf import matched_filter as jmf
from srcfinder_tpu.detect import cnn_pipeline as jcp
from srcfinder_tpu.detect import fcn_pipeline as jfp
from srcfinder_tpu.models import googlenet as jgooglenet
from srcfinder_tpu.models.googlenet import fold_inference as jfold
from srcfinder_tpu.parallel import make_mesh as jmake_mesh
from srcfinder_tpu.parallel import shard_columns_mf as jshard_columns_mf
from srcfinder_tpu.parallel import shard_fcn_shifts as jshard_fcn_shifts
from srcfinder_torch import parallel
from srcfinder_torch.cmf import matched_filter as tmf
from srcfinder_torch.detect import cnn_pipeline as tcp
from srcfinder_torch.detect import fcn_pipeline as tfp
from srcfinder_torch.models import convert
from srcfinder_torch.models.googlenet import GoogLeNet, fold_inference

torch.set_num_threads(1)

MESH = ["cpu"] * 8
FCN_IMG = (20, 45)
CNN_IMG = (9, 13)                 # 117 windows: 15 batches of 8 over 8 shards


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- mesh
def test_make_mesh_cpu_lists_and_ranges():
    cpu = torch.device("cpu")
    assert parallel.make_mesh(8, "cpu") == [cpu] * 8
    assert parallel.make_mesh(None, "cpu") == [cpu]
    assert parallel.make_mesh(device=MESH) == [cpu] * 8       # repeats kept
    with pytest.raises(ValueError, match="n_devices=3"):
        parallel.make_mesh(3, MESH)
    with pytest.raises(ValueError, match="unsupported device"):
        parallel.make_mesh(2, "mps")
    for n, k in ((16, 8), (13, 8), (3, 8), (117, 4)):
        sizes = [b - a for a, b in parallel.column_ranges(n, k)]
        assert sizes == [len(p) for p in torch.tensor_split(torch.arange(n), k)]


def test_make_mesh_cuda_raises_and_never_falls_back(monkeypatch):
    """Without a card a CUDA mesh raises; with too few it raises; it never
    shrinks or returns the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh(2, "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.as_mesh(["cuda:0"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.make_mesh(None, "cuda") == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="a mesh of 4 cards needs 4"):
        parallel.make_mesh(4, "cuda")
    assert parallel.as_mesh(["cuda:0"] * 4) == [torch.device("cuda", 0)] * 4
    with pytest.raises(RuntimeError, match="cuda:2 does not exist"):
        parallel.as_mesh(["cuda:0", "cuda:2"])
    with pytest.raises(ValueError, match="a list of devices"):
        parallel.make_mesh(2, "cuda:1")


def test_run_shards_reraises_and_keeps_modes():
    def fn(i, dev):
        if i == 3:
            raise KeyError("shard 3")
        return i, torch.is_inference_mode_enabled()

    with pytest.raises(KeyError, match="shard 3"):
        parallel.run_shards(MESH, fn)
    with torch.inference_mode():
        out = parallel.run_shards(MESH, lambda i, dev: (i, torch.is_inference_mode_enabled()))
    assert out == [(i, True) for i in range(8)]


# -------------------------------------------------------------------- CMF
def _cmf_inputs(rng, L=64, C=16, B=8):
    """test_sharded_columns_match_single_device's data (test_cmf_pipeline.py:185)."""
    x = np.abs(rng.normal(loc=4.0, size=(L, C, B))).astype(np.float32) + 0.5
    abscf = (-np.abs(rng.normal(size=B)) * 0.1).astype(np.float32)
    alphas = jmf.default_alphas(np.float32)
    m = np.asarray(jmf.valid_mask(x)).astype(np.float32)
    return x, m, abscf, alphas


def _assert_mf_equal(got, ref, rtol):
    for f in ref._fields:
        a, b = getattr(got, f).numpy(), getattr(ref, f).numpy()
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=f)


def test_shard_columns_mf_matches_single_and_jax(rng):
    x, m, abscf, alphas = _cmf_inputs(rng)
    args = (_t(x), _t(m), _t(abscf), _t(alphas))
    single = tmf.matched_filter_columns(*args)
    sharded = parallel.shard_columns_mf(MESH, *args)
    _assert_mf_equal(sharded, single, 1e-6)
    ref = jshard_columns_mf(jmake_mesh(8), x, m, abscf, alphas)
    np.testing.assert_allclose(sharded.mf.numpy(), np.asarray(ref.mf), rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(sharded.alpha_index.numpy(), np.asarray(ref.alpha_index))


def test_shard_columns_mf_uneven_columns(rng):
    """C = 13 over 8 shards (2, 2, 2, 2, 2, 1, 1, 1 columns), with the
    full-target keyword T split with the columns."""
    x, m, abscf, alphas = _cmf_inputs(rng, C=13)
    args = (_t(x), _t(m), _t(abscf), _t(alphas))
    _assert_mf_equal(parallel.shard_columns_mf(MESH, *args),
                     tmf.matched_filter_columns(*args), 1e-6)
    T = tmf.masked_moments(args[0], args[1])[2] * 1.5
    _assert_mf_equal(parallel.shard_columns_mf(MESH, *args, T=T),
                     tmf.matched_filter_columns(*args, T=T), 1e-6)


def _bimodal(rng):
    """test_sharded_multimodal_matches_single_device's data
    (test_cmf_pipeline.py:289): the first half of the lines raised."""
    L, C, B = 96, 16, 8
    x = np.abs(rng.normal(4.0, 1.0, size=(L, C, B))).astype(np.float32) + 0.5
    x[:L // 2] += 4.0
    abscf = (-np.abs(rng.normal(size=B)) * 0.1).astype(np.float32)
    alphas = jmf.default_alphas(np.float32)
    m = np.asarray(jmf.valid_mask(x)).astype(np.float32)
    return x, m, abscf, alphas


def test_shard_columns_multimodal_matches_single_with_its_seed(rng):
    """The sharded k-means++ draws the single call's uniforms (all columns
    at once, then each shard its columns): labels equal for one seed."""
    x, m, abscf, alphas = _bimodal(rng)
    args = (_t(x), _t(m), _t(abscf), _t(alphas))
    for seed in (0, 5):
        single = tmf.matched_filter_columns_multimodal(*args, bgmodes=2, pcadim=4, seed=seed)
        sharded = parallel.shard_columns_mf(MESH, *args, bgmodes=2, pcadim=4, seed=seed)
        _assert_mf_equal(sharded, single, 1e-6)


def test_shard_columns_multimodal_matches_jax_sharded(rng):
    """Against JAX's multimodal CMF on the column-sharded 8-device mesh,
    from JAX's own k-means++ seeds (torch cannot draw jax.random's)."""
    x, m, abscf, alphas = _bimodal(rng)
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jmake_mesh(8)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "data", None)))
    ms = jax.device_put(jnp.asarray(m), NamedSharding(mesh, P(None, "data")))
    ref = jmf.matched_filter_columns_multimodal(xs, ms, jnp.asarray(abscf),
                                                jnp.asarray(alphas), bgmodes=2, pcadim=4)
    z = np.asarray(jkm.masked_pca_project(jnp.asarray(x), jnp.asarray(m), 4))
    seeds = np.asarray(jkm._kpp_init(jnp.asarray(z), jnp.asarray(m), 2, jax.random.PRNGKey(0)))
    d = ((z.transpose(1, 0, 2)[:, None, :, :] - seeds[:, :, None, :]) ** 2).sum(-1)
    init = d.argmin(axis=2)                                     # (C, k) row indices
    got = parallel.shard_columns_mf(MESH, _t(x), _t(m), _t(abscf), _t(alphas), bgmodes=2,
                                    pcadim=4, init_index=_t(init))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.mf.numpy(), np.asarray(ref.mf), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------- models, weights
@pytest.fixture(scope="module")
def variables():
    """Trained-like Flax variables (numpy leaves): the layout from the
    port's model, conv kernels of std sqrt(1 / fan_in), BatchNorm affine
    and running statistics perturbed, so the saliency is far from 0.5."""
    rng = np.random.default_rng(1010)
    v = copy.deepcopy(convert.torch_state_dict_to_flax(GoogLeNet(num_classes=2).state_dict()))

    def walk(p, s):
        for k, a in p.items():
            if k == "bn":
                c = a["scale"].shape
                a["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                a["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(a, dict):
                walk(a, s.get(k, {}))
            elif k == "kernel":
                p[k] = (rng.normal(size=a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                        ).astype(np.float32)
    walk(v["params"], v["batch_stats"])
    return v


def _flax_model():
    return jgooglenet(num_classes=2, dropout=0.0, dropout_aux=0.0)


@pytest.fixture(scope="module")
def port_model(variables):
    model = GoogLeNet(num_classes=2)
    model.load_state_dict(convert.flax_to_torch_state_dict(variables))
    return fold_inference(model.eval())


def _fcn_img():
    return np.random.default_rng(20).normal(size=FCN_IMG).astype(np.float32)


# -------------------------------------------------------------------- FCN
def test_shard_fcn_shifts_matches_jax(variables, port_model):
    img = _fcn_img()
    got = parallel.shard_fcn_shifts(MESH, port_model, _t(img), batch=256).numpy()
    single = tfp.fcn_shift_saliency(port_model, _t(img), batch=256).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jshard_fcn_shifts(jmake_mesh(8), _flax_model(), variables,
                                       jnp.asarray(img), batch=256))
    assert ref.std() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_phase_saliency_mesh_matches_single_and_jax(variables, port_model):
    """The phase pass with its phase batch over 8 shards (from level 3,
    whose 16 maps the mesh divides), and the blocked variant passing the
    mesh on to each window, against the port's single-device calls and
    JAX's mesh= call."""
    img = _fcn_img()
    got = tfp.fcn_phase_saliency(port_model, _t(img), mesh=MESH).numpy()
    single = tfp.fcn_phase_saliency(port_model, _t(img)).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jfp.fcn_phase_saliency(_flax_model(), variables, jnp.asarray(img),
                                            mesh=jmake_mesh(8)))
    assert ref.std() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    blocked = tfp.fcn_phase_saliency_blocked(port_model, _t(img), mesh=MESH).numpy()
    np.testing.assert_allclose(blocked, single, rtol=1e-5, atol=1e-6)
    jblocked = np.asarray(jfp.fcn_phase_saliency_blocked(
        _flax_model(), variables, jnp.asarray(img), mesh=jmake_mesh(8)))
    np.testing.assert_allclose(blocked, jblocked, rtol=1e-5, atol=1e-6)


def test_phase_saliency_blocked_mesh_windows(port_model, monkeypatch):
    """A scene longer than one window: every window gets the mesh, and the
    blocked map equals the single-device blocked map."""
    monkeypatch.setattr(tfp, "TRUNK_HALO", 32)
    img = torch.from_numpy(np.random.default_rng(21).normal(size=(150, 24)).astype(np.float32))
    seen = []
    phase = tfp.fcn_phase_saliency

    def spy(model, x, scale=32, layout="wide", mesh=None):
        seen.append(mesh)
        return phase(model, x, scale, layout, mesh)
    monkeypatch.setattr(tfp, "fcn_phase_saliency", spy)
    got = tfp.fcn_phase_saliency_blocked(port_model, img, block=32, mesh=MESH)
    assert len(seen) == 5 and all(m == MESH for m in seen)
    ref = tfp.fcn_phase_saliency_blocked(port_model, img, block=32)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- exact CNN
def test_cnn_window_saliency_sharded_matches_single_and_jax(variables, port_model):
    """Windows over 8 shards in whole batches: bit-equal to the port's
    single-device call on every trunk route, within 1e-5 of JAX's
    cnn_window_saliency_sharded."""
    img = np.random.default_rng(22).normal(0.0, 3.0, CNN_IMG).astype(np.float32)
    for trunk in tcp.TRUNKS:
        single = tcp.cnn_window_saliency(port_model, _t(img), dim=32, batch=8, trunk=trunk)
        got = tcp.cnn_window_saliency_sharded(port_model, _t(img), MESH, dim=32, batch=8,
                                              trunk=trunk)
        np.testing.assert_array_equal(got.numpy(), single.numpy())
    fmodel, fvars = jfold(_flax_model(), variables)
    ref = jcp.cnn_window_saliency_sharded(fmodel, fvars, jnp.asarray(img), jmake_mesh(8),
                                          dim=32, batch=8)
    assert np.asarray(ref).std() > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_launch_counts_exact_under_threads():
    """Sharded calls launch from several threads at once: every launch
    counts (``ops/build.py`` counts under a lock). 16 threads, more than
    a typical test host's cores, with a 1 us switch interval."""
    import sys
    import threading
    from srcfinder_torch.ops import build

    kernel = build.CudaKernel("moments.cu", {"f": [], "g": []})

    class Lib:                                   # a launch that succeeds
        f = g = staticmethod(lambda *a: 0)
    kernel._lib = Lib()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda fn: [kernel.launch(fn) for _ in range(2000)],
                                    args=("fg"[i % 2],)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 32000 and kernel.counts == {"f": 16000, "g": 16000}
