"""Data-parallel training of the port (``srcfinder_torch.train.ddp``, the
cross-replica BatchNorm of ``models/googlenet.py``, the DDP path of
``train/sam.py`` and ``TrainConfig(devices=N)``) on the CPU: 2 gloo ranks
in processes of their own, held against the port's single-process run and
against the JAX package's ``TrainConfig(devices=2)``.

Everything runs in float64 with dropout 0 (the ranks draw their masks
from generators seeded by rank, which no single-process run can
reproduce), crop 32, on GoogLeNet-1ch with aux heads from one start
checkpoint. Bounds, per tensor by relative L2 (||dp - ref|| / ||ref||; a
parameter by its change from the start):

- DP_TOL = 1e-7 against the single-process f64 run (parameters,
  BatchNorm running statistics, momentum); the batch-0 loss within
  LOSS_ATOL = 1e-10 and later losses within rtol DP_LOSS_RTOL = 1e-8.
  The two runs differ only in summation order: the BatchNorm statistics
  come from E[x^2] - E[x]^2 over an all-reduce instead of torch's own
  batch_norm, and DDP's gradient average reassociates. At batch 4 (2 rows
  a rank) and crop 32, inception5's BatchNorm normalises 4 values, and
  each SAM step at these rates multiplies a difference by ~1e3: the
  losses differ by 7e-15, 6e-12 and 3.3e-9 (1.4e-9 relative) over the
  three steps, the worst tensor by 1.2e-8 after them (a momentum buffer);
  one SGD step on the class-skewed batch by 3.3e-13, two replicated SAM
  steps by 1.9e-11 (measured on the CPU). A wrong step (a per-rank
  weighted mean, per-rank BatchNorm statistics) moves tensors by 1e-3 and
  more.
- JAX_TOL = 1e-5 against the JAX package's ``TrainConfig(devices=2)`` in
  a process with JAX_ENABLE_X64=1 (the bound of tests/test_torch_train.py's
  f64 step comparisons), losses within LOSS_RTOL = 1e-6.
- Two DP runs are bit-identical.

The ranks import this module to find their worker: it imports no JAX at
its top.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srcfinder_torch.models import convert
from srcfinder_torch.models.googlenet import GoogLeNet
from srcfinder_torch.train import cli as tcli
from srcfinder_torch.train import ddp
from srcfinder_torch.train import sam as tsam
from srcfinder_torch.train import train as ttrain

torch.set_num_threads(1)

CROP, BATCH = 32, 4
CLASS_W = [1.0, 5 / 3]
STEP_LRS = [0.05, 0.05, 0.01]
EXP_LR = 0.02
DP_TOL = 1e-7
LOSS_ATOL = 1e-10
DP_LOSS_RTOL = 1e-8
JAX_TOL = 1e-5
LOSS_RTOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def f64_model(seed, device):
    """The trainer's network in float64 with dropout 0 (``make_model``'s
    stand-in in the experiments here; the ranks find it by name)."""
    gen = torch.Generator().manual_seed(seed)
    return GoogLeNet(num_classes=2, aux_logits=True, dropout=0.0, dropout_aux=0.0,
                     generator=gen).double().to(device).train()


def _start_model(workdir, device="cpu"):
    model = f64_model(0, device)
    ttrain.load_into(model, ttrain.load_checkpoint(os.path.join(workdir, "start.npz")))
    return model


def _run_steps(model, images, labels, use_sam, lrs, rank=0, world=1, dev=torch.device("cpu")):
    """``lrs`` steps on one global batch, data-parallel when ``world`` > 1;
    returns the losses and the state (parameters, running statistics,
    momentum) as numpy."""
    opt = tsam.make_inner_optimizer(model.parameters())
    net = model if world == 1 else ddp.wrap(model, dev)
    make = tsam.make_sam_train_step if use_sam else tsam.make_sgd_train_step
    step = make(net, opt, torch.tensor(CLASS_W, dtype=torch.float64, device=dev))
    x, y, group = images, labels, None
    if world > 1:
        x, y, group = ddp.shard_batch(images, labels, rank, world)
    xt = torch.from_numpy(np.ascontiguousarray(x[..., 0]))[:, None].double()
    yt = torch.from_numpy(y.astype(np.int64))
    losses = [float(step(xt, yt, lr, torch.Generator().manual_seed(i), group=group))
              for i, lr in enumerate(lrs)]
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    state.update({f"momentum:{k}": opt.state[p]["momentum_buffer"].numpy().copy()
                  for k, p in model.named_parameters()})
    return np.asarray(losses), state


def _dp_worker(rank, world, dev, workdir, tag, use_sam, lrs, out):
    """One rank: the steps of :func:`_run_steps` from the start checkpoint
    on the batch ``workdir/<tag>.npz``; rank 0 writes ``out``."""
    batch = np.load(os.path.join(workdir, f"{tag}.npz"))
    losses, state = _run_steps(_start_model(workdir, dev), batch["images"], batch["labels"],
                               use_sam, lrs, rank, world, dev)
    if rank == 0:
        np.savez(out, losses=losses, **state)


def _dp(workdir, tag, use_sam=True, lrs=STEP_LRS, run=0):
    out = os.path.join(workdir, f"{tag}_dp{run}.npz")
    backend = ddp.spawn(_dp_worker, 2, "cpu", os.path.join(workdir, f"{tag}_{run}.rdv"),
                        args=(workdir, tag, use_sam, lrs, out))
    assert backend == "gloo"
    got = np.load(out)
    return got["losses"], {k: got[k] for k in got.files if k != "losses"}


def _single(workdir, tag, use_sam=True, lrs=STEP_LRS):
    batch = np.load(os.path.join(workdir, f"{tag}.npz"))
    return _run_steps(_start_model(workdir), batch["images"], batch["labels"], use_sam, lrs)


def _write_batch(workdir, tag, labels, seed=3):
    images = np.random.default_rng(seed).normal(size=(len(labels), CROP, CROP, 1))
    np.savez(os.path.join(workdir, f"{tag}.npz"), images=images.astype(np.float32),
             labels=np.asarray(labels, np.int32))


def _assert_states_close(got, ref, start, tol):
    """Every tensor within ``tol`` (relative L2), parameters by their change
    from ``start``; returns the largest distance."""
    worst = 0.0
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            continue
        d = (_rel(got[k] - start[k], v - start[k]) if k in start and "running" not in k
             else _rel(got[k], v))
        assert d < tol, (k, d)
        worst = max(worst, d)
    return worst


# ------------------------------------------------------------- the JAX side
def _jax_main(workdir):
    """JAX_ENABLE_X64=1: the JAX package's TrainConfig(devices=2) on the
    tiny campaign (SAM, 2 epochs, lr EXP_LR, resumed from start.npz), its
    model factory patched to float64 with dropout 0."""
    import jax
    import jax.numpy as jnp
    import importlib
    from srcfinder_tpu.models import googlenet as jgooglenet
    from test_torch_train import _JittedFlax
    assert jax.config.jax_enable_x64 and len(jax.devices()) >= 2
    jtrain = importlib.import_module("srcfinder_tpu.train.train")
    model = jgooglenet(num_classes=2, dropout=0.0, dropout_aux=0.0, dtype=jnp.float64)
    jtrain.googlenet = lambda num_classes: _JittedFlax(model)
    cfg = jtrain.TrainConfig(os.path.join(workdir, "data"), "COVID_QC", lr=EXP_LR,
                             augment="augB", crop=CROP, epochs=2,
                             outroot=os.path.join(workdir, "jax_exp"), use_sam=True,
                             batch_size=BATCH, resume=os.path.join(workdir, "start.npz"),
                             devices=2)
    _, outdir, metrics = jtrain.train_experiment(cfg, progress=lambda *a: None)
    with open(os.path.join(workdir, "jax_exp.json"), "w") as f:
        json.dump({"outdir": outdir, "metrics": metrics}, f, default=float)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The start checkpoint (the trainer's f64 init, seed 9), the tiny
    campaign, and the JAX run of :func:`_jax_main` started in the
    background (it is read by the last test)."""
    from test_torch_train import _campaign
    wd = str(tmp_path_factory.mktemp("ddp"))
    start = f64_model(9, "cpu")
    convert.save_weights(os.path.join(wd, "start.npz"),
                         convert.torch_state_dict_to_flax(start.state_dict()))
    _campaign(os.path.join(wd, "data"))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
    proc = subprocess.Popen([sys.executable, "-c",
                             "import sys, test_torch_train_ddp as T; T._jax_main(sys.argv[1])",
                             wd], env=env)
    yield wd, proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _start_state(wd):
    return {k: v.numpy() for k, v in _start_model(wd).state_dict().items()}


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def mixed(workdir):
    """Three SAM steps, batch 4 over 2 ranks (2 rows each)."""
    wd, _ = workdir
    _write_batch(wd, "mixed", [1, 0, 1, 0])
    return _dp(wd, "mixed")


def test_dp_sam_steps_match_single_process(workdir, mixed):
    """The three DP SAM steps against the single-process f64 run."""
    wd, _ = workdir
    losses, got = mixed
    ref_losses, ref = _single(wd, "mixed")
    assert abs(losses[0] - ref_losses[0]) <= LOSS_ATOL
    np.testing.assert_allclose(losses, ref_losses, rtol=DP_LOSS_RTOL)
    _assert_states_close(got, ref, _start_state(wd), DP_TOL)


def test_dp_runs_are_bit_identical(workdir, mixed):
    wd, _ = workdir
    losses, got = mixed
    again_losses, again = _dp(wd, "mixed", run=1)
    np.testing.assert_array_equal(again_losses, losses)
    for k, v in got.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_dp_gradient_of_class_skewed_batch(workdir):
    """The loss trap: every positive in rank 0's rows. Each rank's loss is
    its share of the global weighted mean (not its own weighted mean), so
    one SGD step's momentum (the gradient plus weight decay) and the step
    equal the single run's."""
    wd, _ = workdir
    _write_batch(wd, "skewed", [1, 1, 0, 0], seed=4)
    losses, got = _dp(wd, "skewed", use_sam=False, lrs=[0.05])
    ref_losses, ref = _single(wd, "skewed", use_sam=False, lrs=[0.05])
    assert abs(losses[0] - ref_losses[0]) <= LOSS_ATOL
    _assert_states_close(got, ref, _start_state(wd), DP_TOL)


def test_dp_uneven_batch_runs_replicated(workdir):
    """B = 5 over 2 ranks: the batch runs whole on each rank, BatchNorm
    without cross-replica reduction, as the JAX step runs it replicated."""
    wd, _ = workdir
    _write_batch(wd, "uneven", [1, 0, 0, 1, 0], seed=5)
    losses, got = _dp(wd, "uneven", lrs=[0.05, 0.01])
    ref_losses, ref = _single(wd, "uneven", lrs=[0.05, 0.01])
    assert abs(losses[0] - ref_losses[0]) <= LOSS_ATOL
    np.testing.assert_allclose(losses, ref_losses, rtol=DP_LOSS_RTOL)
    _assert_states_close(got, ref, _start_state(wd), DP_TOL)


def _read_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_train_cli_devices_2_writes_each_file_once(workdir, capfd):
    """``--devices 2 --device cpu``: rank 0 alone writes the CSVs (one row
    per global batch), metrics.json and one final npz; nothing else is left
    in the run's directory (the rendezvous file is gone)."""
    wd, _ = workdir
    rc = tcli.main([os.path.join(wd, "data"), "COVID_QC", "--crop", "32", "--epochs", "2",
                    "--batch", "3", "--augment", "augB", "--outroot", os.path.join(wd, "cli"),
                    "--device", "cpu", "--devices", "2"])
    assert rc == 0
    out = capfd.readouterr().out
    assert "(gloo)" in out and out.count("Epoch ") == 2
    outdir = out.split("experiment dir: ")[1].splitlines()[0]
    assert sorted(os.listdir(outdir)) == ["batch_losses.csv", "epoch_losses.csv",
                                          "epoch_times.csv", "metrics.json",
                                          "val_losses.csv", "weights"]
    weights = os.listdir(os.path.join(outdir, "weights"))
    assert len(weights) == 1 and weights[0].startswith("final_")
    # 8 tiles in batches of 3, 3 (run whole on each rank) and 2 (a row a rank)
    rows = _read_rows(os.path.join(outdir, "batch_losses.csv"))
    assert [r[:2] for r in rows[1:]] == [[str(e), str(b)] for e in (0, 1) for b in range(3)]
    assert len(_read_rows(os.path.join(outdir, "epoch_losses.csv"))) == 3
    assert len(_read_rows(os.path.join(outdir, "val_losses.csv"))) == 3
    ttrain.load_into(GoogLeNet(num_classes=2, aux_logits=True),
                     ttrain.load_checkpoint(os.path.join(outdir, "weights", weights[0])))


def _flags_worker(rank, world, dev, out):
    with open(f"{out}.{rank}", "w") as f:
        json.dump([str(dev), world, torch.backends.cudnn.allow_tf32,
                   torch.backends.cuda.matmul.allow_tf32], f)


def test_ranks_pin_tf32_off(tmp_path):
    """Each rank runs as a single-card run does: full f32, TF32 off for
    cuDNN's convolutions too (a fresh process has it on)."""
    out = str(tmp_path / "flags")
    ddp.spawn(_flags_worker, 2, "cpu", str(tmp_path / "rdv"), args=(out,))
    for r in range(2):
        with open(f"{out}.{r}") as f:
            assert json.load(f) == ["cpu", 2, False, False]
    assert not os.path.exists(tmp_path / "rdv")


def test_devices_on_cards_need_as_many_cards(monkeypatch):
    """``--devices N --device cuda`` gives each rank a card and raises with
    fewer; ``cuda:0`` puts every rank on that card over gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a mesh of 2 cards needs 2"):
        ddp.rank_devices("cuda", 2)
    one = ddp.rank_devices("cuda:0", 2)
    assert one == [torch.device("cuda", 0)] * 2 and ddp.backend_for(one) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    four = ddp.rank_devices("cuda", 4)
    assert [d.index for d in four] == [0, 1, 2, 3] and ddp.backend_for(four) == "nccl"
    assert ddp.backend_for(ddp.rank_devices("cpu", 2)) == "gloo"


def test_dp_experiment_matches_jax_devices_2(workdir, monkeypatch):
    """TrainConfig(devices=2) in both packages, float64, dropout 0, SAM, two
    epochs of the tiny campaign (4 steps of 4 rows, 2 a rank) from one start
    checkpoint: batch and validation losses within LOSS_RTOL, the final
    parameters' change from the start within JAX_TOL."""
    wd, proc = workdir
    monkeypatch.setattr(ttrain, "make_model", f64_model)
    cfg = ttrain.TrainConfig(os.path.join(wd, "data"), "COVID_QC", lr=EXP_LR, augment="augB",
                             crop=CROP, epochs=2, outroot=os.path.join(wd, "torch_exp"),
                             use_sam=True, batch_size=BATCH, device="cpu",
                             resume=os.path.join(wd, "start.npz"), devices=2)
    model, tdir, tmetrics = ttrain.train_experiment(cfg, progress=lambda *a: None)
    assert model.fc.weight.dtype == torch.float64
    assert proc.wait(timeout=900) == 0
    with open(os.path.join(wd, "jax_exp.json")) as f:
        jdir = json.load(f)["outdir"]
    for name in ("batch_losses.csv", "epoch_losses.csv", "val_losses.csv"):
        j, t = _read_rows(os.path.join(jdir, name)), _read_rows(os.path.join(tdir, name))
        assert len(j) == len(t) and j[0] == t[0], name
        for a, b in zip(j[1:], t[1:]):
            assert a[:-1] == b[:-1], name
            assert float(b[-1]) == pytest.approx(float(a[-1]), rel=LOSS_RTOL), name
    start = convert.flax_to_torch_state_dict(
        ttrain.load_checkpoint(os.path.join(wd, "start.npz")), aux_heads=True)
    jfinal = [f for f in os.listdir(os.path.join(jdir, "weights")) if f.startswith("final")]
    jsd = convert.flax_to_torch_state_dict(
        ttrain.load_checkpoint(os.path.join(jdir, "weights", jfinal[0])), aux_heads=True)
    tsd = model.state_dict()
    for k, _ in model.named_parameters():
        assert _rel(tsd[k] - start[k], jsd[k] - start[k]) < JAX_TOL, k
    for k in tsd:
        if "running" in k:
            assert _rel(tsd[k], jsd[k]) < JAX_TOL, k
