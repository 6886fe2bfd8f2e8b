"""The port's trainer (``srcfinder_torch.train``, GoogLeNet-1ch with aux
heads in training mode, ``core.geotiff``) held against the JAX package's
on the CPU.

Both sides start from one set of Flax variables, made by the JAX package's
own ``init`` (train mode, so the aux heads exist) and carried into the
port by ``models.convert.flax_to_torch_state_dict(aux_heads=True)``.
Dropout is 0 on both sides: the port draws its masks from a
``torch.Generator``, which cannot reproduce ``jax.random``.

Tolerances, each stated where it is used. The train-mode forward: FWD_TOL
of each output's largest magnitude, for each side against the other and
against the port's f64 forward (at this init and batch 4 a train-mode
BatchNorm normalises by the variance of 4 values at inception5).
Optimizer steps run in float64 on both sides, the JAX package's in a
process of its own with ``JAX_ENABLE_X64=1`` (its model built with
``dtype=float64``): at the JAX package's init (conv weights of std 0.01,
which each BatchNorm divides out, so gradients scale with 1 / 0.01) and
batch 4 the gradients are cancellations, and the f32 rounding of one
step, grown through three, leaves no bound that would tell a wrong step
from a right one. In f64 each tensor's change from the start, its
BatchNorm running statistics and its momentum buffer are compared by the
relative L2 distance ||port - jax|| / ||jax||, bounded by STEP_TOL.
"""

import csv
import importlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from srcfinder_tpu.core import geotiff as jgeotiff
from srcfinder_tpu.models import googlenet as jgooglenet
from srcfinder_tpu.train import data as jdata
from srcfinder_tpu.train import sam as jsam
from srcfinder_torch.core import geotiff as tgeotiff
from srcfinder_torch.models import convert
from srcfinder_torch.models.googlenet import GoogLeNet
from srcfinder_torch.train import cli as tcli
from srcfinder_torch.train import data as tdata
from srcfinder_torch.train import sam as tsam
from test_train import _TorchSAM

jtrain = importlib.import_module("srcfinder_tpu.train.train")
ttrain = importlib.import_module("srcfinder_torch.train.train")
tgooglenet = importlib.import_module("srcfinder_torch.models.googlenet")

torch.set_num_threads(1)

CROP, BATCH = 32, 4
FWD_TOL = 1e-4
STEP_TOL = 1e-5
EXP_TOL = 1e-4
LOSS_RTOL = 1e-6
CLASS_W = [1.0, 5 / 3]                  # loss_weights_for the tiny campaign
STEP_CASES = [(True, 0.0), (True, 0.3), (False, 0.0), (False, 0.3)]
STEP_LRS = [0.05, 0.05, 0.01]
EXP_LR = 0.02


def _jmodel():
    return jgooglenet(num_classes=2, dropout=0.0, dropout_aux=0.0)


def _tmodel():
    return GoogLeNet(num_classes=2, aux_logits=True, dropout=0.0, dropout_aux=0.0)


@pytest.fixture(scope="module")
def jvars():
    """The JAX package's init in train mode (aux heads included), numpy
    leaves; one jitted trace serves the module."""
    model = _jmodel()
    init = jax.jit(lambda k: model.init({"params": k, "dropout": k},
                                        jnp.zeros((1, CROP, CROP, 1)), train=True))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(9)))


def _port_model(variables):
    model = _tmodel()
    model.load_state_dict(convert.flax_to_torch_state_dict(variables, aux_heads=True))
    return model.train()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x[..., 0]))[:, None]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _images(seed, crop=CROP, n=BATCH):
    return np.random.default_rng(seed).normal(size=(n, crop, crop, 1)).astype(np.float32)


def _stats(sd):
    return {k: v.numpy() for k, v in sd.items() if "running" in k}


@pytest.mark.parametrize("crop", [32, 64])
def test_train_forward_with_aux_matches_jax(jvars, crop, monkeypatch):
    """Train-mode forward with aux heads at crop 32 (inception4a is 2 x 2:
    the aux pool's 2 -> 4 bins overlap; inception5 is 1 x 1, so its
    BatchNorm sees n = 4 values a channel) and 64: logits, aux2 and aux1
    within FWD_TOL of their largest magnitude, each also within FWD_TOL of
    the port's f64 forward, and the running statistics after the pass
    within FWD_TOL of flax's (of each tensor's largest magnitude), which
    update the variance with the biased batch variance. torch's own BatchNorm2d update (unbiased) would
    be off by n / (n - 1) = 4/3 in the variance's update at crop 32."""
    x = _images(crop, crop)
    jm = _jmodel()
    (logits, aux2, aux1), mut = jax.jit(lambda v, xx: jm.apply(
        v, xx, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(jvars, x)
    model = _port_model(jvars)
    f64 = _port_model(jvars).double()
    with torch.no_grad():
        out = model(_nchw(x))
        out64 = f64(_nchw(x).double())
    assert isinstance(out, tuple) and len(out) == 3
    for got, ref, r64 in zip(out, (logits, aux2, aux1), out64):
        ref, scale = np.asarray(ref), float(r64.abs().max())
        assert np.abs(got.numpy() - ref).max() <= FWD_TOL * scale
        assert np.abs(got.numpy() - r64.numpy()).max() <= FWD_TOL * scale
        assert np.abs(ref - r64.numpy()).max() <= FWD_TOL * scale
    ref = _stats(convert.flax_to_torch_state_dict(
        {"params": jvars["params"], "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])},
        aux_heads=True))
    got = _stats(model.state_dict())
    assert ref.keys() == got.keys() and any(k.startswith("aux1.") for k in got)
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= FWD_TOL * np.abs(ref[k]).max(), k
    if crop == 32:
        # the same f64 pass with torch's BatchNorm2d update: the variance's
        # update is 4/3 of flax's at inception5 (n = 4), and the running
        # variance leaves FWD_TOL
        key = "inception5b.branch1.bn.running_var"
        upd_port = f64.state_dict()[key].numpy() - 0.9
        monkeypatch.setattr(tgooglenet.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward)
        plain = _port_model(jvars).double()
        with torch.no_grad():
            plain(_nchw(x).double())
        var_plain = plain.state_dict()[key].numpy()
        np.testing.assert_allclose((var_plain - 0.9) / upd_port, 4 / 3, rtol=1e-9)
        assert np.abs(var_plain - ref[key]).max() > FWD_TOL * np.abs(ref[key]).max()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _step_inputs():
    return _images(3), np.array([1, 0, 1, 0], np.int32)


class _JittedFlax:
    """The experiment's model with its init and its eval-mode apply jitted
    (``train_experiment`` calls them eagerly, op by op: most of a tiny
    experiment's time on the CPU); the train step's apply, traced inside
    the step's own jit, is the module's."""

    def __init__(self, module):
        self.module = module
        self._init = jax.jit(lambda rngs, x: module.init(rngs, x, train=True))
        self._eval = jax.jit(lambda v, x: module.apply(v, x, train=False))

    def init(self, rngs, x, train):
        assert train
        return self._init(rngs, x)

    def apply(self, variables, x, train=False, **kw):
        if train or kw:
            return self.module.apply(variables, x, train=train, **kw)
        return self._eval(variables, x)


def _x64_main(workdir):
    """The JAX side of the float64 comparisons, in a process started with
    JAX_ENABLE_X64=1: three steps of each STEP_CASES case from
    ``workdir/start.npz`` on f32 images (as the dataset gives them), then
    the 2-epoch tiny experiment resumed from it (the model factory patched
    to dtype float64, dropout 0)."""
    assert jax.config.jax_enable_x64
    # the experiment's step is the SGD case without aux loss compiled again
    # (same HLO): the process's compilation cache serves it
    jax.config.update("jax_compilation_cache_dir", os.path.join(workdir, "jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    model = jgooglenet(num_classes=2, dropout=0.0, dropout_aux=0.0, dtype=jnp.float64)
    start = jtrain.load_checkpoint(os.path.join(workdir, "start.npz"))
    images, labels = _step_inputs()
    for use_sam, aux_weight in STEP_CASES:
        opt = jsam.make_inner_optimizer()
        state = jsam.TrainState(start["params"], start["batch_stats"],
                                opt.init(start["params"]))
        w = jnp.asarray(CLASS_W)
        step = (jsam.make_sam_train_step(model, opt, w, aux_weight=aux_weight) if use_sam
                else jsam.make_sgd_train_step(model, opt, w, aux_weight=aux_weight))
        losses = []
        for i, lr in enumerate(STEP_LRS):
            state, loss = step(state, jnp.asarray(images), jnp.asarray(labels),
                               jsam.step_lr(lr, 1, 0), jax.random.PRNGKey(i))
            losses.append(float(loss))
        trace = optax.tree_utils.tree_get(state.opt_state, "trace")
        np.savez(os.path.join(workdir, f"steps_{use_sam}_{aux_weight}.npz"),
                 losses=np.asarray(losses),
                 **_flat({"params": state.params, "batch_stats": state.batch_stats}),
                 **_flat({"trace": trace}))
    jtrain.googlenet = lambda num_classes: _JittedFlax(model)
    cfg = jtrain.TrainConfig(os.path.join(workdir, "data"), "COVID_QC", lr=EXP_LR,
                             augment="augB", crop=CROP, epochs=2,
                             outroot=os.path.join(workdir, "jax_exp"), use_sam=False,
                             batch_size=BATCH, resume=os.path.join(workdir, "start.npz"))
    _, outdir, metrics = jtrain.train_experiment(cfg, progress=lambda *a: None)
    with open(os.path.join(workdir, "jax_exp.json"), "w") as f:
        json.dump({"outdir": outdir, "metrics": metrics}, f, default=float)


@pytest.fixture(scope="module")
def x64(jvars, tmp_path_factory):
    """Run :func:`_x64_main` once: the start npz (the JAX init in f64) and
    the tiny campaign are written here, the JAX results read back."""
    workdir = str(tmp_path_factory.mktemp("x64"))
    convert.save_weights(os.path.join(workdir, "start.npz"),
                         jax.tree.map(lambda a: a.astype(np.float64), jvars))
    _campaign(os.path.join(workdir, "data"))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
    subprocess.run([sys.executable, "-c",
                    "import sys, test_torch_train as T; T._x64_main(sys.argv[1])", workdir],
                   check=True, env=env, timeout=900)
    return workdir


def _port_f64(workdir):
    model = _tmodel().double()
    ttrain.load_into(model, ttrain.load_checkpoint(os.path.join(workdir, "start.npz")))
    return model.train()


@pytest.mark.parametrize("use_sam,aux_weight", STEP_CASES)
def test_steps_match_jax(x64, use_sam, aux_weight):
    """Three SAM (or SGD) steps on GoogLeNet-1ch with aux heads (crop 32,
    batch 4, dropout 0), aux_weight 0 and 0.3, in float64, against the JAX
    package's make_sam_train_step / make_sgd_train_step from the same
    variables: losses within LOSS_RTOL; each parameter's change from the start,
    the BatchNorm running statistics and SGD's momentum within STEP_TOL
    (relative L2). At aux_weight 0 the aux heads get no gradient from the
    loss, yet JAX decays them and their momentum grows: so must the
    port's."""
    ref = np.load(os.path.join(x64, f"steps_{use_sam}_{aux_weight}.npz"))
    jsd = {k: v.numpy() for k, v in convert.flax_to_torch_state_dict(
        {k: ref[k] for k in ref.files if k.split("/")[0] in ("params", "batch_stats")},
        aux_heads=True).items()}
    trace = convert.unflatten({k: ref[k] for k in ref.files if k.startswith("trace/")})
    jmom = {k: v.numpy() for k, v in convert.flax_to_torch_state_dict(
        {"params": trace["trace"]}, aux_heads=True).items()}

    model = _port_f64(x64)
    start = {k: v.clone().numpy() for k, v in model.state_dict().items()}
    opt = tsam.make_inner_optimizer(model.parameters())
    w = torch.tensor(CLASS_W, dtype=torch.float64)
    step = (tsam.make_sam_train_step(model, opt, w, aux_weight=aux_weight) if use_sam
            else tsam.make_sgd_train_step(model, opt, w, aux_weight=aux_weight))
    images, labels = _step_inputs()
    x, y = _nchw(images).double(), torch.from_numpy(labels.astype(np.int64))
    losses = [float(step(x, y, lr, torch.Generator().manual_seed(i)))
              for i, lr in enumerate(STEP_LRS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    names = dict(model.named_parameters())
    assert set(jmom) >= set(names)
    for k, p in names.items():
        assert _rel(sd[k] - start[k], jsd[k] - start[k]) < STEP_TOL, k
        assert _rel(opt.state[p]["momentum_buffer"].numpy(), jmom[k]) < STEP_TOL, k
    for k in _stats(model.state_dict()):
        assert _rel(sd[k], jsd[k]) < STEP_TOL, k
    # the aux heads moved by weight decay alone at aux_weight 0
    aux_mom = opt.state[names["aux1.fc1.weight"]]["momentum_buffer"]
    assert float(aux_mom.abs().max()) > 0


def test_linear_sam_step_matches_torch_oracle():
    """The port's SAM step on a linear classifier against the torch SAM
    oracle of tests/test_train.py (davda54/sam semantics), three steps:
    weights within rtol 1e-6 (atol 1e-7)."""
    rng = np.random.default_rng(42)
    din, dout, n = 5, 2, 16
    W0 = rng.normal(size=(din, dout)).astype(np.float32)
    b0 = rng.normal(size=(dout,)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(n, din)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, dout, n))
    wce = torch.tensor([1.0, 3.0])
    lr, rho, wd, mom = 0.01, 0.5, 5e-4, 0.9

    def linear():
        lin = torch.nn.Linear(din, dout)
        lin.weight.data = torch.from_numpy(W0.T.copy())
        lin.bias.data = torch.from_numpy(b0.copy())
        return lin

    ref = linear()
    opt = _TorchSAM(ref.parameters(), torch.optim.SGD, rho=rho, adaptive=True,
                    lr=lr, momentum=mom, weight_decay=wd)
    lossf = torch.nn.CrossEntropyLoss(weight=wce)
    for _ in range(3):
        lossf(ref(x), y).backward()
        opt.first_step()
        lossf(ref(x), y).backward()
        opt.second_step()

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = linear()

        def forward(self, xx, generator=None):
            return self.lin(xx)

    got = Lin()
    step = tsam.make_sam_train_step(
        got, tsam.make_inner_optimizer(got.parameters(), momentum=mom, weight_decay=wd),
        wce, rho=rho, adaptive=True)
    for _ in range(3):
        step(x, y, lr)
    np.testing.assert_allclose(got.lin.weight.detach().numpy(), ref.weight.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.lin.bias.detach().numpy(), ref.bias.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def test_weighted_ce_and_step_lr_match_jax():
    """weighted_cross_entropy within rtol 1e-6 of the JAX package's; the
    StepLR schedule gives the JAX package's f32 rate at every epoch 0-99 of
    100 (and 0-6 of 7)."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 16)
    w = np.array([1.0, 7.3], np.float32)
    ref = float(jsam.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            jnp.asarray(w)))
    got = float(tsam.weighted_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(labels), torch.from_numpy(w)))
    assert got == pytest.approx(ref, rel=1e-6)
    for total in (100, 7):
        for e in range(100 if total == 100 else 7):
            got = np.float32(tsam.step_lr(1e-3, total, e))
            assert got == np.asarray(jsam.step_lr(1e-3, total, e)), (total, e)


def _campaign(root, n=8, size=40, fmt="npy", writer=tgeotiff.write_geotiff,
              campaign="COVID_QC", seed=42):
    """A tiny tile campaign (the layout of tests/test_train.py's fixture):
    n tiles of 4 bands, CH4 in band 4, labels 1 / 0 / -1 in turn."""
    rng = np.random.default_rng(seed)
    cdir = os.path.join(root, campaign, "tiles")
    os.makedirs(cdir, exist_ok=True)
    rows = []
    for i in range(n):
        lab = 1 if i % 3 == 0 else (0 if i % 3 == 1 else -1)
        tile = (np.abs(rng.normal(size=(4, size, size))) * 200).astype(np.float32)
        if lab == 1:
            tile[3, size // 3:size // 2, size // 3:size // 2] += 1500
        if fmt == "tif":
            path = os.path.join(cdir, f"t{i}.tif")
            writer(path, np.moveaxis(tile, 0, -1))
        else:
            path = os.path.join(cdir, f"t{i}.npy")
            np.save(path, tile)
        rows.append((f"tiles/{os.path.basename(path)}", lab))
    for name, sel in [("train.csv", rows), ("test.csv", rows[:4]),
                      ("data_labels.csv", rows)]:
        with open(os.path.join(root, campaign, name), "w") as f:
            f.write("path,label\n")
            for p, lab in sel:
                f.write(f"{p},{lab}\n")
    return root


@pytest.mark.parametrize("fmt", ["npy", "tif"])
@pytest.mark.parametrize("augment", ["augA", "augB", "augC"])
def test_dataset_batches_bit_equal_to_jax(tmp_path, fmt, augment):
    """Two shuffled epochs of batches from the port's TiledDataset equal the
    JAX package's bit for bit (images and labels), for .npy and .tif
    tiles: the seeded generator is consumed in the same order."""
    root = _campaign(str(tmp_path), fmt=fmt, n=7)
    rows = tdata.load_labels_csv(os.path.join(root, "COVID_QC", "train.csv"))
    assert rows == jdata.load_labels_csv(os.path.join(root, "COVID_QC", "train.csv"))
    assert tdata.loss_weights_for(rows) == jdata.loss_weights_for(rows)
    mean, std = tdata.TRAIN_CAMPAIGN_NORM["COVID_QC"]
    kw = dict(crop=CROP, augment=augment, seed=3)
    tds = tdata.TiledDataset(os.path.join(root, "COVID_QC"), rows, mean, std, **kw)
    jds = jdata.TiledDataset(os.path.join(root, "COVID_QC"), rows, mean, std, **kw)
    for _ in range(2):
        tb, jb = list(tds.batches(3)), list(jds.batches(3))
        assert len(tb) == len(jb) == 3
        for (ti, tl), (ji, jl) in zip(tb, jb):
            assert ti.dtype == ji.dtype and ti.shape == ji.shape
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("compress", [None, "lzw"])
def test_geotiff_bytes_equal_both_ways(tmp_path, compress):
    """The port's GeoTIFF writer gives the JAX package's bytes (UTM map
    info, nodata; none and LZW), and each package reads the other's file
    to the same array and metadata."""
    rng = np.random.default_rng(11)
    arr = (rng.normal(size=(37, 23, 4)) * 100).astype(np.float32)
    m = {"proj": "UTM", "ulx": 272247.15, "uly": 3992010.65, "xps": 3.1,
         "yps": 3.1, "zone": 11, "hemi": "North"}
    tp, jp = str(tmp_path / "t.tif"), str(tmp_path / "j.tif")
    tgeotiff.write_geotiff(tp, arr, mapinfo=m, nodata=-9999, compress=compress)
    jgeotiff.write_geotiff(jp, arr, mapinfo=m, nodata=-9999, compress=compress)
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((tgeotiff.read_geotiff, jp), (jgeotiff.read_geotiff, tp)):
        back, meta = reader(path)
        np.testing.assert_array_equal(back, arr)
        assert meta["epsg"] == 32611 and meta["nodata"] == -9999.0
    # a single-band int16 raster without georeferencing
    band = rng.integers(-500, 500, (19, 31)).astype(np.int16)
    tgeotiff.write_geotiff(tp, band, compress=compress)
    jgeotiff.write_geotiff(jp, band, compress=compress)
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(tgeotiff.read_geotiff(jp)[0], band)


@pytest.mark.parametrize("case", ["ties", "no_positive", "no_negative", "separated",
                                  "random"])
def test_evaluate_threshold_matches_jax(case):
    """The port's numpy threshold search and report against the JAX
    package's (scikit-learn's precision_recall_curve and
    classification_report, zero_division=0): threshold, F1, precision and
    recall equal (rtol 1e-12), the report's every number within 1e-12.
    Cases: tied scores, one class absent (each way), perfect separation,
    random scores."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 2, 40)
    probs = rng.uniform(size=40)
    if case == "ties":
        probs = np.round(probs * 4) / 4
    elif case == "no_positive":
        labels = np.zeros(40, np.int64)
    elif case == "no_negative":
        labels = np.ones(40, np.int64)
    elif case == "separated":
        probs = np.where(labels == 1, 0.6 + 0.4 * probs, 0.5 * probs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # scikit-learn: no positive class
        ref = jtrain.evaluate_threshold(probs, labels)
    got = ttrain.evaluate_threshold(probs, labels)
    for k in ("threshold", "f1", "precision", "recall"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k
    assert got["report"].keys() == ref["report"].keys()
    for k, v in ref["report"].items():
        if isinstance(v, dict):
            assert got["report"][k].keys() == v.keys()
            for kk in v:
                assert got["report"][k][kk] == pytest.approx(v[kk], rel=1e-12), (k, kk)
        else:
            assert got["report"][k] == pytest.approx(v, rel=1e-12), k


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def experiments(x64):
    """One 2-epoch tiny experiment in each package (crop 32, batch 4, augB,
    SGD, dropout 0 through their model factories, float64), both resumed
    from one npz of the JAX-initialised variables: the JAX package's from
    :func:`_x64_main`, the port's here."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "make_model", lambda seed, device: _tmodel().double().to(device).train())
    try:
        cfg = ttrain.TrainConfig(os.path.join(x64, "data"), "COVID_QC", lr=EXP_LR,
                                 augment="augB", crop=CROP, epochs=2,
                                 outroot=os.path.join(x64, "torch_exp"), use_sam=False,
                                 batch_size=BATCH, device="cpu",
                                 resume=os.path.join(x64, "start.npz"))
        model, tdir, tmetrics = ttrain.train_experiment(cfg, progress=lambda *a: None)
    finally:
        mp.undo()
    with open(os.path.join(x64, "jax_exp.json")) as f:
        j = json.load(f)
    return {"jax": (None, j["outdir"], j["metrics"]), "torch": (model, tdir, tmetrics),
            "root": os.path.join(x64, "data"), "start": os.path.join(x64, "start.npz")}


def test_tiny_experiment_matches_jax(experiments):
    """The two float64 experiments: batch and validation losses within
    LOSS_RTOL, final parameters' change from the shared start within
    EXP_TOL (relative L2; four SAM steps, each carrying the last one's
    rounding into a step of lr 0.02 at batch 4), the best-F1 threshold within 2e-6 and the same F1; the
    port writes the JAX package's files (CSVs, metrics.json, final npz)
    and its epoch_times.csv."""
    out, start = experiments, experiments["start"]
    (_, jdir, jmetrics), (model, tdir, tmetrics) = out["jax"], out["torch"]
    for name in ("batch_losses.csv", "epoch_losses.csv", "val_losses.csv"):
        j, t = _read_csv(os.path.join(jdir, name)), _read_csv(os.path.join(tdir, name))
        assert len(j) == len(t) and j[0] == t[0], name
        for a, b in zip(j[1:], t[1:]):
            assert a[:-1] == b[:-1], name
            assert float(b[-1]) == pytest.approx(float(a[-1]), rel=LOSS_RTOL), name
    times = _read_csv(os.path.join(tdir, "epoch_times.csv"))
    assert times[0] == ["epoch", "batches", "data_s", "step_s", "wall_s"] and len(times) == 3
    assert tmetrics["threshold"] == pytest.approx(jmetrics["threshold"], abs=2e-6)
    assert tmetrics["f1"] == pytest.approx(jmetrics["f1"], abs=1e-12)
    with open(os.path.join(tdir, "metrics.json")) as f:
        assert json.load(f)["val_report"].keys() == jmetrics["val_report"].keys()
    s0 = convert.flax_to_torch_state_dict(ttrain.load_checkpoint(start), aux_heads=True)
    jfinal = [f for f in os.listdir(os.path.join(jdir, "weights")) if f.startswith("final")]
    jsd = convert.flax_to_torch_state_dict(
        ttrain.load_checkpoint(os.path.join(jdir, "weights", jfinal[0])), aux_heads=True)
    tsd = model.state_dict()
    for k, _ in model.named_parameters():
        assert _rel(tsd[k] - s0[k], jsd[k] - s0[k]) < EXP_TOL, k


def test_checkpoints_cross_both_ways(experiments, tmp_path):
    """A checkpoint written by the JAX package resumes in the port (one
    epoch from --start-epoch 1), and the port's final npz loads in the JAX
    package (f32 here): its eval-mode logits lie within FWD_TOL of their
    largest magnitude from the port model's; the port's torch.save
    checkpoint holds the same tree."""
    root, out = experiments["root"], experiments
    (_, jdir, _), (model, tdir, _) = out["jax"], out["torch"]
    jfinal = [f for f in os.listdir(os.path.join(jdir, "weights")) if f.startswith("final")]
    cfg = ttrain.TrainConfig(root, "COVID_QC", lr=0.02, augment="augA", crop=CROP,
                             epochs=2, start_epoch=1, outroot=str(tmp_path / "r"),
                             use_sam=False, batch_size=BATCH, device="cpu",
                             resume=os.path.join(jdir, "weights", jfinal[0]))
    _, rdir, _ = ttrain.train_experiment(cfg, progress=lambda *a: None)
    rows = _read_csv(os.path.join(rdir, "epoch_losses.csv"))
    assert len(rows) == 2 and rows[1][0] == "1"

    tfinal = [f for f in os.listdir(os.path.join(tdir, "weights")) if f.startswith("final")]
    tree = jtrain.load_checkpoint(os.path.join(tdir, "weights", tfinal[0]))
    x = _images(17)
    jm = _jmodel()
    ref = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}, x)
    model.eval()
    with torch.no_grad():
        got = model(_nchw(x).double()).numpy()
    model.train()
    assert np.abs(got - np.asarray(ref)).max() <= FWD_TOL * np.abs(got).max()

    pt = str(tmp_path / "c.pt")
    ttrain.save_checkpoint_pt(pt, model)
    flat_a = _flat(ttrain.load_checkpoint_pt(pt))
    flat_b = _flat(ttrain.load_checkpoint(os.path.join(tdir, "weights", tfinal[0])))
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        np.testing.assert_array_equal(v, flat_b[k], err_msg=k)


def test_train_cli_cpu_writes_files_and_trains_on_devices(tmp_path, capfd):
    """``python -m srcfinder_torch.train.cli`` on the CPU: one epoch of SGD
    on the tiny campaign writes the loss CSVs, metrics.json and a final npz
    that loads strictly into GoogLeNet(aux_logits=True); --devices 2 trains
    data-parallel over 2 gloo ranks and writes the same files
    (tests/test_torch_train_ddp.py holds its steps to the single run's)."""
    root = _campaign(str(tmp_path / "data"))
    rc = tcli.main([root, "COVID_QC", "--crop", "32", "--epochs", "1", "--batch", "4",
                    "--no-sam", "--augment", "augC", "--outroot", str(tmp_path / "o"),
                    "--device", "cpu"])
    assert rc == 0
    outdir = capfd.readouterr().out.split("experiment dir: ")[1].splitlines()[0]
    for name in ("batch_losses.csv", "epoch_losses.csv", "val_losses.csv",
                 "epoch_times.csv", "metrics.json"):
        assert os.path.isfile(os.path.join(outdir, name)), name
    final = [f for f in os.listdir(os.path.join(outdir, "weights")) if f.startswith("final")]
    ttrain.load_into(_tmodel(), ttrain.load_checkpoint(os.path.join(outdir, "weights", final[0])))
    rc = tcli.main([root, "COVID_QC", "--crop", "32", "--epochs", "1", "--batch", "4",
                    "--no-sam", "--augment", "augC", "--outroot", str(tmp_path / "dp"),
                    "--device", "cpu", "--devices", "2"])
    assert rc == 0
    out = capfd.readouterr().out
    assert "Data-parallel over 2 ranks" in out and "(gloo)" in out
    dpdir = out.split("experiment dir: ")[1].splitlines()[0]
    for name in ("batch_losses.csv", "epoch_losses.csv", "val_losses.csv",
                 "epoch_times.csv", "metrics.json"):
        assert os.path.isfile(os.path.join(dpdir, name)), name
    final = [f for f in os.listdir(os.path.join(dpdir, "weights")) if f.startswith("final")]
    ttrain.load_into(_tmodel(), ttrain.load_checkpoint(os.path.join(dpdir, "weights", final[0])))


def test_folded_and_fused_models_refuse_train():
    """The inference transforms are inference-only (JAX package:
    models/googlenet.py:122-123); the inference state_dict has no aux
    heads."""
    for kw in ({"fused": True}, {"folded": True}):
        m = GoogLeNet(num_classes=2, **kw)
        m.eval()
        with pytest.raises(ValueError, match="inference-only"):
            m.train()
    assert not any(k.startswith("aux") for k in GoogLeNet().state_dict())
