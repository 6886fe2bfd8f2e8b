"""The import guard compares whole top-level names, and nothing the harness
loads brings in JAX or the JAX package."""

import subprocess
import sys

from conftest import REPO
from portbench import harness


def test_guard_compares_top_level_names_whole():
    found = harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "srcfinder_tpu.ops",
                                       "srcfinder_torch", "srcfinder_torch.ops", "jaxtyping",
                                       "flaxen", "srcfinder_tpu_extra", "numpy"])
    assert found == ["flax", "jax", "jaxlib", "srcfinder_tpu"]
    assert harness.forbidden_modules(["srcfinder_torch.detect", "torch"]) == []


def test_the_harness_drivers_and_metrics_load_no_jax():
    code = (
        "import sys, runpy\n"
        "from portbench import harness, control, trace, checks, envi, inputs\n"
        "from portbench.counts import work, cmf_kernels\n"
        "from portbench.reference import cmf, googlenet, post\n"
        "for d in harness.names('drivers'): harness.load_module('drivers', d)\n"
        "for m in harness.names('metrics'): harness.load_module('metrics', m)\n"
        "import srcfinder_torch.flow.pipeline_cli, srcfinder_torch.detect.cnn_pipeline\n"
        "runpy.run_path('portbench/run.py', run_name='not_main')\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
