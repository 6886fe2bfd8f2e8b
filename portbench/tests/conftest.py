"""Fixtures of the benchmark's own tests (run them with
``python -m pytest portbench/tests``): a tiny copy of the benchmark's tree
for runs on the CPU, and the skip of the tests that need a card."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# sizes of the CPU runs: a 320 x 12 scene whose 4 x 6 plume passes IME's threshold (a
# plume on many of a column's few lines is absorbed by its covariance), 3-line blocks of
# a 10 x 8 band (every window checked), 64-pixel windows
TINY_SCENE = dict(lines=320, samples=12, plume_lines=[150, 154], plume_samples=[3, 9],
                  absorb_factor=0.99, noise_sd=0.01, write_block_lines=64)
TINY_BAND = dict(lines=10, samples=8, dim=64, plumes=2, nodata_pixels=[[0, 0], [5, 3]])
TINY_TRAFFIC = dict(block_lines=3, batch=7, check_windows_per_call=24)
# the bf16 exact CNN's limit on the CPU, where one call's 24 windows are its whole
# sample (program 0.85-2.66 at seeds 3-7 and the tests' seed, fp8 control 14.5-20.9 at
# seeds 5-7); the other cells keep their own limits
TINY_LIMITS = {"bfloat16": {"saliency_rms_ratio": 6.0}}
# the bf16 cell's calls split over four "cards" (the CPU four times) through the
# mesh branch of the exact CNN's driver
TINY_MESH_CELL = "exact-cnn-bf16-x4"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


def build_tiny(dst):
    """A copy of BENCHMARK.json and portbench/ (tests left out) under
    ``dst``, its configurations and traffic cut to CPU sizes, with the
    four-card twin of the bf16 cell added; returns (portbench dir, root)."""
    here = os.path.join(dst, "portbench")
    shutil.copytree(os.path.join(REPO, "portbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    for name in os.listdir(os.path.join(here, "configs")):
        path = os.path.join(here, "configs", name)
        cfg = json.load(open(path))
        cfg.update(TINY_SCENE if "scene_name" in cfg else TINY_BAND)
        json.dump(cfg, open(path, "w"))
    for name in os.listdir(os.path.join(here, "traffic")):
        path = os.path.join(here, "traffic", name)
        tr = json.load(open(path))
        if "block_lines" in tr:
            tr.update(TINY_TRAFFIC)
        json.dump(tr, open(path, "w"))
    wl = json.load(open(os.path.join(here, "workloads", "exact-cnn-bf16.json")))
    json.dump(dict(wl, chips=4), open(os.path.join(here, "workloads", TINY_MESH_CELL + ".json"),
                                      "w"))
    for name in os.listdir(os.path.join(here, "workloads")):
        path = os.path.join(here, "workloads", name)
        wl = json.load(open(path))
        tr = json.load(open(os.path.join(here, "traffic", wl["traffic"] + ".json")))
        wl["limits"] = TINY_LIMITS.get(tr.get("dtype"), wl["limits"])
        json.dump(wl, open(path, "w"))
    return here, dst


@pytest.fixture
def tiny_tree(tmp_path):
    return build_tiny(str(tmp_path))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
