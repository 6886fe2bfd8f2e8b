"""Runs of the harness on the CPU at tiny sizes (the look for a card
skipped): a sound run is ``correct``; a run whose timed path is broken
underneath is not, once for each fault its cell can have; and each cell's
control, one precision step below, reads above one of its limits."""

import pytest
import torch

from portbench import control, harness


def run(tiny_tree, cell, seed=2 ** 31 + 11, trace=0):
    here, root = tiny_tree
    return harness.run_cell(cell, seed, 0.1, trace, device="cpu", here=here, root=root)


CELLS = ["flightline-2801-snr-shift", "exact-cnn-bf16", "exact-cnn-bf16-x4", "exact-cnn-f32"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_tree, cell):
    r = run(tiny_tree, cell, trace=cell == "exact-cnn-f32")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def _altered_windows(monkeypatch, fn):
    from srcfinder_torch.detect import cnn_pipeline
    real = cnn_pipeline._WindowForward.__call__
    monkeypatch.setattr(cnn_pipeline._WindowForward, "__call__",
                        lambda self, padded, origins, dim: fn(real, self, padded, origins, dim))


def _answer_altered(real, self, padded, origins, dim):
    p = real(self, padded, origins, dim)
    return torch.where(p > 0.5, p - 0.05, p + 0.05)


def _half_batch_left_out(real, self, padded, origins, dim):
    half = origins.shape[0] // 2 or 1
    p = real(self, padded, origins[:half], dim)
    return torch.cat([p, p.mean().expand(origins.shape[0] - half)])


@pytest.mark.parametrize("cell", ["exact-cnn-bf16", "exact-cnn-bf16-x4", "exact-cnn-f32"])
@pytest.mark.parametrize("fault", [_answer_altered, _half_batch_left_out])
def test_a_broken_window_forward_is_not_correct(tiny_tree, monkeypatch, cell, fault):
    _altered_windows(monkeypatch, fault)
    r = run(tiny_tree, cell)
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_a_mesh_without_its_exchange_is_not_correct(tiny_tree, monkeypatch):
    from srcfinder_torch.parallel import mesh
    real = mesh.gather

    def no_exchange(parts, device):
        return real([parts[0]] + [torch.zeros_like(p) for p in parts[1:]], device)
    monkeypatch.setattr(mesh, "gather", no_exchange)
    r = run(tiny_tree, "exact-cnn-bf16-x4")
    assert not r["correct"], r["checks"]


def _cmf_altered(monkeypatch):
    from srcfinder_torch.cmf import matched_filter as mfmod
    real = mfmod.matched_filter_columns

    def altered(*a, **k):
        res = real(*a, **k)
        return res._replace(mf=res.mf * 1.001)
    monkeypatch.setattr(mfmod, "matched_filter_columns", altered)


def _saliency_altered(monkeypatch):
    from srcfinder_torch.flow import pipeline_cli
    real = pipeline_cli.fcn_saliency_image

    def altered(img, *a, **k):
        sal = real(img, *a, **k)
        return torch.where(sal >= 0, (sal + 0.01).clamp(max=1.0), sal)
    monkeypatch.setattr(pipeline_cli, "fcn_saliency_image", altered)


def _plumes_altered(monkeypatch):
    from srcfinder_torch.flow import pipeline_cli
    real = pipeline_cli.salience2detections

    def altered(*a, **k):
        df = real(*a, **k)
        df["cmfmed"] = df["cmfmed"] * 1.01
        return df
    monkeypatch.setattr(pipeline_cli, "salience2detections", altered)


def _ime_altered(monkeypatch):
    from srcfinder_torch.flow import ime_worker
    real = ime_worker.detection_ime_stats

    def altered(*a, **k):
        df = real(*a, **k)
        assert len(df), "the tiny scene's plume must give IME rows"
        return df.assign(ime_kg=df.ime_kg * 1.01)
    monkeypatch.setattr(ime_worker, "detection_ime_stats", altered)


@pytest.mark.parametrize("fault", [_cmf_altered, _saliency_altered, _plumes_altered,
                                   _ime_altered])
def test_a_flightline_with_an_altered_product_is_not_correct(tiny_tree, monkeypatch, fault):
    fault(monkeypatch)
    r = run(tiny_tree, "flightline-2801-snr-shift")
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_a_limit(tiny_tree, cell):
    import os
    import tempfile
    here, _ = tiny_tree
    wl = harness.load_json(os.path.join(here, "workloads", cell + ".json"))
    cfg = harness.load_json(os.path.join(here, "configs", wl["config"] + ".json"))
    tr = harness.load_json(os.path.join(here, "traffic", wl["traffic"] + ".json"))
    dev = torch.device("cpu")
    with tempfile.TemporaryDirectory() as wd:
        ctx = harness.Context(cell, 5, cfg, tr, wl["limits"], 1, [dev], wd)
        readings = (control.flightline_readings(ctx, dev) if tr["driver"] == "flightline"
                    else control.exact_cnn_readings(ctx, dev, 2))
    assert any(readings[k] > v for k, v in wl["limits"].items() if k in readings), readings
