"""The masks cell (``flightline-2801-masks-shift``) on the CPU at a tiny size:
a sound run is ``correct``, and each fault its check exists for is not (a
flipped mask pixel, a mask file that differs between flightlines, an empty
flare band, a CMF value altered on a clear pixel of a quiet column, a value
that is not finite off them). The features are placed
in the first 24 columns of a 320 x 32 scene of 15.5 m pixels (10-pixel
radii, one mask block), which leaves 8 quiet columns."""

import json
import os
import tempfile

import numpy as np
import pytest

from portbench import harness

CELL = "flightline-2801-masks-shift"
SEED = 2 ** 31 + 23
TINY_FEATURES = {
    "flares": {"cores": [[30, 16], [110, 16], [280, 16]], "size": 4, "radiance": 12.0},
    "small_flares": {"cores": [[200, 4]], "size": 2, "radiance": 12.0},
    "glint": {"boxes": [[240, 2, 6, 8]], "radiance": 12.0},
    "clouds": {"discs": [[60, 5, 6], [180, 18, 5]]},
    "shadows": {"offset": [8, 4], "radiance": 0.08},
}
CLEAR_PIXEL = (90, 28)       # in a quiet column
FEATURE_PIXEL = (150, 10)    # in a column that holds a cloud


def tiny_masks(tiny_tree):
    here, root = tiny_tree
    wl = harness.load_json(os.path.join(here, "workloads", CELL + ".json"))
    path = os.path.join(here, "configs", wl["config"] + ".json")
    cfg = harness.load_json(path)
    cfg["samples"] = 32
    cfg["map_info"][5] = cfg["map_info"][6] = "15.5"
    for key, value in TINY_FEATURES.items():
        cfg["features"][key] = dict(cfg["features"][key], **value)
    json.dump(cfg, open(path, "w"))
    return here, root


@pytest.fixture
def tree(tiny_tree):
    return tiny_masks(tiny_tree)


def run(tree):
    here, root = tree
    return harness.run_cell(CELL, SEED, 0.1, 0, device="cpu", here=here, root=root)


def value(r, name):
    return r["checks"][name]["value"]


def test_a_sound_masks_run_is_correct(tree, capfd):
    """The CMF over every pixel and over the clear ones is printed with its
    denominator and held to no limit; the quiet columns' gap is."""
    r = run(tree)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert value(r, "masks_gap") == 0 and value(r, "mask_features_missing") == 0
    assert set(r["checks"]) == {"saliency_gap", "plumes_gap", "ime_gap", "cmf_gap_quiet",
                                "masks_gap", "mask_features_missing"}
    err = capfd.readouterr().err
    for name in ("cmf_gap", "cmf_gap_clear", "cmf_gap_quiet"):
        assert f"{name} " in err and "(limit" in err and "max |ref|" in err, err


def _flip_one_pixel(monkeypatch, calls=None):
    """The program's mask with one clear pixel's cloud flag set; with
    ``calls``, only on the flightlines after the first ``calls``."""
    from srcfinder_torch.masks import cli
    real = cli.masks_for_cube
    seen = []

    def flipped(*a, **k):
        out = real(*a, **k)
        seen.append(1)
        if calls is None or len(seen) > calls:
            out[CLEAR_PIXEL + (0,)] = 1
        return out
    monkeypatch.setattr(cli, "masks_for_cube", flipped)


def test_a_flipped_mask_pixel_reads_a_masks_gap(tree, monkeypatch):
    _flip_one_pixel(monkeypatch)
    r = run(tree)
    assert value(r, "masks_gap") == 1 and not r["correct"] and r["failed"] >= 1, r["checks"]


def test_a_mask_file_that_differs_between_flightlines_reads_inf(tree, monkeypatch):
    """Two window flightlines, the second's mask altered: whichever the seed
    draws, the other's file differs."""
    import torch
    here, _ = tree
    _flip_one_pixel(monkeypatch, calls=2)           # the warm-up and the first are sound
    wl = harness.load_json(os.path.join(here, "workloads", CELL + ".json"))
    cfg = harness.load_json(os.path.join(here, "configs", wl["config"] + ".json"))
    tr = harness.load_json(os.path.join(here, "traffic", wl["traffic"] + ".json"))
    driver = harness.load_module("drivers", tr["driver"], here)
    with tempfile.TemporaryDirectory() as wd:
        d = driver.Driver(harness.Context(CELL, SEED, cfg, tr, wl["limits"], 1,
                                          [torch.device("cpu")], wd))
        d.setup()
        d.unit()
        d.unit()
        rows, failed = d.check()
    got = {r["name"]: r["value"] for r in rows}
    assert got["masks_gap"] == float("inf") and failed >= 1, got


def test_an_empty_flare_band_fails_the_features(tree, monkeypatch):
    from srcfinder_torch.masks import sds
    monkeypatch.setattr(sds, "grow_flare_mask",
                        lambda sat, *a, **k: np.zeros(np.shape(sat), np.uint8))
    r = run(tree)
    assert value(r, "mask_features_missing") > 0 and not r["correct"], r["checks"]


def _alter_cmf(monkeypatch, pixel, change):
    """The program's ppm*m band with ``pixel`` set to ``change(band)``."""
    from srcfinder_torch.flow import pipeline_cli
    from portbench.envi import read_header
    real = pipeline_cli.robust_mf_image

    def altered(radiance, library, out, *a, **k):
        res = real(radiance, library, out, *a, **k)
        h = read_header(out + ".hdr")
        shape = tuple(int(h[k]) for k in ("lines", "samples", "bands"))
        assert h["interleave"].lower() == "bip"
        band = np.memmap(out, dtype={"4": "<f4", "5": "<f8"}[h["data type"]], mode="r+",
                         shape=shape)[..., 3]
        band[pixel] = change(band)
        band.flush()
        return res
    monkeypatch.setattr(pipeline_cli, "robust_mf_image", altered)


def test_a_cmf_value_altered_on_a_clear_pixel_fails_cmf_gap_quiet(tree, monkeypatch):
    """One clear pixel of a quiet column moved by 10% of the product's
    largest |ppm*m|."""
    _alter_cmf(monkeypatch, CLEAR_PIXEL,
               lambda band: band[CLEAR_PIXEL] + 0.1 * np.abs(band[band != -9999.0]).max())
    r = run(tree)
    assert value(r, "cmf_gap_quiet") > r["checks"]["cmf_gap_quiet"]["limit"], r["checks"]
    assert not r["correct"] and r["failed"] >= 1


def test_a_value_that_is_not_finite_off_the_quiet_columns_fails(tree, monkeypatch):
    """A NaN in a column that holds a feature, where no limit holds the gap."""
    _alter_cmf(monkeypatch, FEATURE_PIXEL, lambda band: np.nan)
    r = run(tree)
    assert value(r, "cmf_gap_quiet") == 1e308 and not r["correct"] and r["failed"] >= 1
