"""The harness finds its cells, configurations, traffic, drivers and metrics
as files, BENCHMARK.json keeps to the contract's names and links, and a run
without a card or without the program gives no result."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import REPO
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.spec(REPO)


def test_every_entry_has_its_file():
    assert set(w["name"] for w in BENCH["workloads"]) <= set(harness.names("workloads"))
    assert set(harness.names("configs")) >= {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    metrics = set(harness.names("metrics"))
    for m in BENCH["per_layer"]:
        assert m["name"] in metrics
        assert callable(harness.load_module("metrics", m["name"]).read)
    for cell in harness.names("workloads"):
        wl = harness.load_json(os.path.join(harness.HERE, "workloads", cell + ".json"))
        assert wl["config"] in harness.names("configs")
        tr = harness.load_json(os.path.join(harness.HERE, "traffic", wl["traffic"] + ".json"))
        assert tr["driver"] in harness.names("drivers")


def test_a_dropped_in_cell_and_metric_are_found(tmp_path):
    here = str(tmp_path / "portbench")
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = harness.load_json(os.path.join(here, "workloads", "exact-cnn-f32.json"))
    wl["traffic"] = "blocks-f32-b1024"
    json.dump(wl, open(os.path.join(here, "workloads", "exact-cnn-f32-b1024.json"), "w"))
    tr = harness.load_json(os.path.join(here, "traffic", "blocks-f32-b512.json"))
    json.dump(dict(tr, batch=1024), open(os.path.join(here, "traffic", "blocks-f32-b1024.json"),
                                         "w"))
    with open(os.path.join(here, "metrics", "calls_done.py"), "w") as f:
        f.write("def read(run):\n    return run.units\n")
    assert "exact-cnn-f32-b1024" in harness.names("workloads", here)
    assert "blocks-f32-b1024" in harness.names("traffic", here)
    assert harness.load_module("metrics", "calls_done", here).read(
        harness.Run(None, 1.0, 3, {}, {})) == 3


def test_names_units_and_lines_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] \
        + [w["traffic"] for w in BENCH["workloads"]] \
        + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] \
        + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]] \
        + BENCH["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_cell_file_matches_benchmark_json():
    for w in BENCH["workloads"]:
        wl = harness.load_json(os.path.join(harness.HERE, "workloads", w["name"] + ".json"))
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])


def test_per_layer_cells_report_the_metric_they_move():
    for w in BENCH["workloads"]:
        cell = w["name"]
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(BENCH, cell, "per_layer")
        assert layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_run_without_its_cards_fails_with_no_result(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(2 ** 31 + 7), "--seconds", "1"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_a_tree_without_the_program_fails(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from portbench import harness; "
            "print(harness.run_cell('exact-cnn-f32', 3, 1, 0, device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and "srcfinder_torch" in p.stderr and p.stdout.strip() == ""
