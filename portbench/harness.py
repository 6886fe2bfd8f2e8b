"""The benchmark's machinery, driven by data: a cell is
``workloads/<cell>.json`` (its configuration, traffic mix, chips, why and the
limits of its checks), a configuration is ``configs/<name>.json``, a traffic
mix is ``traffic/<name>.json`` (the parameters its driver,
``drivers/<driver>.py``, reads), and a per-layer metric is
``metrics/<name>.py`` with a ``read(run)`` that returns the value or None.
Which metrics a cell reports, and their units, come from ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "srcfinder_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def spec(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def names(kind, here=HERE):
    """Names of the cells ("workloads"), configurations ("configs"),
    traffic mixes, drivers or metrics found as files of their folder."""
    ext = ".py" if kind in ("drivers", "metrics") else ".json"
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(here, kind))
                  if f.endswith(ext) and not f.startswith("_"))


def load_module(kind, name, here=HERE):
    path = os.path.join(here, kind, name + ".py")
    mod_name = f"portbench.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    sys.modules[mod_name] = mod
    spec_.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, section):
    """Entries of ``section`` that ``cell`` reports: those that list it,
    and those without a list whose moved metric (per-layer) the cell
    reports, or all cells (end-to-end)."""
    e2e = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules(modules=None):
    """Top-level names among ``modules`` (sys.modules by default), compared
    whole, that belong to JAX or to the JAX package."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Context:
    cell: str
    seed: int
    cfg: dict
    traffic: dict
    limits: dict
    chips: int
    devices: list
    workdir: str


@dataclass
class Run:
    """What a per-layer metric's reader may read."""

    ctx: Context
    window_s: float
    units: int
    end_to_end: dict
    layer: dict
    trace: object = None


def finite(v):
    """JSON has no infinity: a reading that is inf (a mask, a row count or a
    text that differs) is printed as 1e308."""
    return v if math.isfinite(v) else 1e308


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None, here=HERE, root=ROOT):
    """Runs cell ``cell`` once; returns the result's dict (``checks`` last).
    ``device="cpu"`` runs the program's plain versions on the host, for the
    tests only."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec(root)
    wl = load_json(os.path.join(here, "workloads", cell + ".json"))
    cfg = load_json(os.path.join(here, "configs", wl["config"] + ".json"))
    traffic = load_json(os.path.join(here, "traffic", wl["traffic"] + ".json"))
    chips = wl["chips"]
    if device == "cuda":
        devices = [torch.device("cuda", i) for i in range(chips)]
    else:
        devices = [torch.device(device)] * chips
    workdir = tempfile.mkdtemp(prefix=f"portbench-{cell}-")
    ctx = Context(cell, int(seed), cfg, traffic, wl["limits"], chips, devices, workdir)
    driver = load_module("drivers", traffic["driver"], here).Driver(ctx)
    try:
        driver.setup()
        cuda = device == "cuda"
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
        tracer = None
        if trace:
            from .trace import Tracer
            tracer = Tracer([d.index or 0 for d in devices])
            tracer.__enter__()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        units = 0
        try:
            while True:
                driver.unit()
                units += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            if cuda:
                for d in devices:
                    torch.cuda.synchronize(d)
            window_s = time.perf_counter() - t0
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
        e2e = dict(driver.end_to_end(window_s), setup_s=setup_s, peak_device_gb=peak / 1e9)
        summary = tracer.summary() if tracer is not None else None
        layer = driver.layer_context()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rows, failed = driver.check()
    finally:
        driver.release()
        shutil.rmtree(workdir, ignore_errors=True)
    run = Run(ctx, window_s, units, e2e, layer, summary)
    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(bench, cell, section):
        value = e2e.get(m["name"]) if not trace else \
            load_module("metrics", m["name"], here).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(r["value"] <= r["limit"] for r in rows), "attempted": units,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.busy_mean_s(), window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps}
    result["checks"] = {r["name"]: {"value": finite(r["value"]), "limit": r["limit"]}
                        for r in rows}
    return result
