"""The multimodal CMF cell (``cmf-2801-multimodal-k4``) on the CPU at a tiny
size: the plain multimodal reference against the port's float64 product,
a sound run is ``correct``, and each fault its check exists for is not (a
flipped label, a rejected mode kept, one mode's ppm*m altered). The tiny
scene is 960 x 12 in two column chunks of 6, four classes in every
column, two runs each; in the last four columns asphalt holds 60 lines,
under bgminsamp 85, and ``-r`` rejects it."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from portbench import checks, harness, product_spans

CELL = "cmf-2801-multimodal-k4"
SEED = 2 ** 31 + 29
SOIL, VEG, CALICHE, ASPHALT = range(4)
BAND = (8, 12)                     # the columns that reject asphalt
TINY_FIELDS = [[l0, l1, 0, 8, k] for k, l0, l1 in (
    (VEG, 0, 120), (CALICHE, 120, 240), (SOIL, 240, 360), (ASPHALT, 360, 480),
    (VEG, 480, 600), (CALICHE, 600, 720), (SOIL, 720, 840), (ASPHALT, 840, 960))] + \
    [[l0, l1, 8, 12, k] for k, l0, l1 in (
        (VEG, 0, 150), (CALICHE, 150, 260), (SOIL, 260, 440), (ASPHALT, 440, 470),
        (VEG, 470, 620), (CALICHE, 620, 810), (SOIL, 810, 930), (ASPHALT, 930, 960))]
TINY_PLUME_LINES = [300, 304]


@pytest.fixture
def tree(tiny_tree):
    here, root = tiny_tree
    wl = harness.load_json(os.path.join(here, "workloads", CELL + ".json"))
    path = os.path.join(here, "configs", wl["config"] + ".json")
    cfg = harness.load_json(path)
    cfg.update(lines=960, plume_lines=TINY_PLUME_LINES)
    cfg["surfaces"]["fields"] = TINY_FIELDS
    json.dump(cfg, open(path, "w"))
    path = os.path.join(here, "traffic", wl["traffic"] + ".json")
    json.dump(dict(harness.load_json(path), col_chunk=6), open(path, "w"))
    return here, root


def _driver(here, wd):
    wl = harness.load_json(os.path.join(here, "workloads", CELL + ".json"))
    cfg = harness.load_json(os.path.join(here, "configs", wl["config"] + ".json"))
    tr = harness.load_json(os.path.join(here, "traffic", wl["traffic"] + ".json"))
    mod = harness.load_module("drivers", tr["driver"], here)
    return mod, mod.Driver(harness.Context(CELL, SEED, cfg, tr, wl["limits"], 1,
                                           [torch.device("cpu")], wd))


def run(tree):
    here, root = tree
    return harness.run_cell(CELL, SEED, 0.1, 0, device="cpu", here=here, root=root)


def value(r, name):
    return r["checks"][name]["value"]


def test_the_reference_matches_the_ports_f64_product(tree):
    """``robust_mf_image(bgmodes=4, reject=True)`` in float64 and the plain
    reference: the same modes once matched, the same pixels without an
    estimate (asphalt's in the band's columns, and the nodata pixels), and
    ppm*m within float64's rounding."""
    from srcfinder_torch.cmf.pipeline import robust_mf_image
    from portbench.envi import read_envi
    here, _ = tree
    with tempfile.TemporaryDirectory() as wd:
        mod, d = _driver(here, wd)
        d.rdn, d.lib, d.absorption = mod.write_scene(wd, d.cfg, SEED, d.dev)
        mod.paint(d.rdn, d.cfg)
        out = os.path.join(wd, "cmf64")
        robust_mf_image(d.rdn, d.lib, out, bgmodes=4, pcadim=6, reject=True,
                        save_bgmeta=True, col_chunk=5, dtype=np.float64, device="cpu")
        got = np.array(read_envi(out)[..., 3])
        ids = np.array(read_envi(out + "_bgmeta")[..., 0])
        ref, given, modes, valid = d.reference()
    planted = mod.class_map(d.cfg)
    assert mod.labels_gap(ids, modes, valid, 4) == 0
    assert mod.labels_gap(planted, modes, valid, 4) == 0
    np.testing.assert_array_equal(got == d.cfg["nodata"], ~given)
    assert np.array_equal(valid & ~given, valid & (planted == ASPHALT)
                          & (np.arange(12) >= BAND[0])[None, :])
    assert (valid & ~given).sum() == 60 * (BAND[1] - BAND[0])
    assert checks.max_rel_gap(got, ref, given) < 1e-10


def test_a_sound_multimodal_run_is_correct(tree, capfd):
    r = run(tree)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert set(r["checks"]) == {"cmf_gap", "labels_gap"}
    assert value(r, "labels_gap") == 0
    assert list(r["metrics"]) == ["flightline_s", "peak_device_gb", "setup_s"]
    err = capfd.readouterr().err
    assert "reference rejects modes [0, 0, 0, 4]" in err, err
    # the program numbers its modes in its own order in each chunk
    assert sum(product_spans.rejected_per_mode(product_spans.last_product())) == 4


def _altered_product(monkeypatch, change):
    """The program's product with ``change(band, ids)`` applied to its ppm*m
    band and cluster ids, in place, after the warm-up."""
    from srcfinder_torch.cmf import pipeline
    from portbench.envi import read_header
    real = pipeline.robust_mf_image

    def altered(infile, library, out, *a, **k):
        res = real(infile, library, out, *a, **k)
        if os.path.basename(out) != "warmup":
            maps = []
            for f, band in ((out, 3), (out + "_bgmeta", 0)):
                h = read_header(f + ".hdr")
                shape = tuple(int(h[k]) for k in ("lines", "samples", "bands"))
                dt = {"2": "<i2", "5": "<f8"}[h["data type"]]
                maps.append(np.memmap(f, dtype=dt, mode="r+", shape=shape)[..., band])
            change(*maps)
            for m in maps:
                m.flush()
        return res
    monkeypatch.setattr(pipeline, "robust_mf_image", altered)


def test_a_flipped_label_reads_a_labels_gap(tree, monkeypatch):
    def flip(band, ids):
        ids[400, 2] = (ids[400, 2] + 1) % 4
    _altered_product(monkeypatch, flip)
    r = run(tree)
    assert value(r, "labels_gap") == pytest.approx(1 / (960 * 12 - 3))
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_a_rejected_mode_kept_reads_inf(tree, monkeypatch):
    from srcfinder_torch.cmf import pipeline
    real = pipeline.robust_mf_image
    monkeypatch.setattr(pipeline, "robust_mf_image",
                        lambda *a, **k: real(*a, **dict(k, reject=False)))
    r = run(tree)
    assert value(r, "cmf_gap") == 1e308 and not r["correct"] and r["failed"] >= 1


def test_one_modes_ppmm_altered_reads_a_cmf_gap(tree, monkeypatch):
    """One column's vegetation pixels (its first field) moved by 1%."""
    def alter(band, ids):
        band[0:120, 5] *= 1.01
    _altered_product(monkeypatch, alter)
    r = run(tree)
    assert value(r, "cmf_gap") > r["checks"]["cmf_gap"]["limit"], r["checks"]
    assert not r["correct"] and r["failed"] >= 1


def test_the_harness_finds_the_cells_files():
    bench = harness.spec()
    assert CELL in harness.names("workloads") and CELL in {w["name"] for w in bench["workloads"]}
    wl = harness.load_json(os.path.join(harness.HERE, "workloads", CELL + ".json"))
    assert wl["traffic"] in harness.names("traffic")
    assert wl["config"] in harness.names("configs")
    tr = harness.load_json(os.path.join(harness.HERE, "traffic", wl["traffic"] + ".json"))
    assert tr["driver"] == "cmf_multimodal" and "cmf_multimodal" in harness.names("drivers")
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")}
    assert layer == {"kmeans_s", "mode_fits_s", "multimodal_cmf_mfu", "eigh_ms",
                     "idle_share.flightline"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")} == {
        "flightline_s", "peak_device_gb", "setup_s"}


def test_the_configurations_fields_keep_to_its_assumptions():
    """Every column holds each class on 10-40% of its lines in at least two
    runs, but asphalt in the rejected band: 60 lines, under bgminsamp; the
    fields tile the scene once; the plume lies in soil."""
    from portbench.drivers.cmf_multimodal import class_map
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "aviris-ng-mixed-surfaces.json"))
    planted = class_map(cfg)
    area = sum((l1 - l0) * (s1 - s0) for l0, l1, s0, s1, _ in cfg["surfaces"]["fields"])
    assert (planted >= 0).all() and area == planted.size
    s0, s1 = cfg["surfaces"]["rejected_band"]["samples"]
    assert s1 - s0 == 96
    B = cfg["active_bands"][1] - cfg["active_bands"][0] + 1
    for c in range(cfg["samples"]):
        col = planted[:, c]
        for k in range(4):
            runs = np.count_nonzero(np.diff(np.r_[0, (col == k).astype(int)]) == 1)
            if s0 <= c < s1 and k == cfg["surfaces"]["rejected_band"]["class"]:
                assert (col == k).sum() == 60 < int((B - 1) * 1.2)
            else:
                assert 0.10 <= (col == k).mean() <= 0.40 and runs >= 2, (c, k)
    (p0, p1), (q0, q1) = cfg["plume_lines"], cfg["plume_samples"]
    assert (planted[p0:p1, q0:q1] == SOIL).all()


def test_the_span_readers_find_nothing_without_products():
    run = harness.Run(None, 1.0, 0, {}, {})
    assert product_spans.seconds_per_product(run, ("cmf.pca",)) is None
    for name in ("kmeans_s", "mode_fits_s"):
        assert harness.load_module("metrics", name).read(run) is None
