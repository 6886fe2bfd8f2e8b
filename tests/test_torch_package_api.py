"""The port's package-level names against the JAX package's: every name a
subpackage ``__init__`` of the JAX package imports resolves in the port's
subpackage of the same name (but for the names ROADMAP.md section 1 leaves
out on purpose), ``__version__``, and ``models.load_pt`` giving the JAX
package's Flax tree from one ``.pt`` file."""

import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import srcfinder_tpu
import srcfinder_torch
from srcfinder_tpu.models import convert as jconvert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: names the port does not carry on purpose (ROADMAP.md section 1): the
#: TPU-side prefetch, the orbax checkpoint pair and TrainState, and the
#: jax.sharding helpers
LEFT_OUT = {
    "core": {"prefetch_to_device"},
    "train": {"TrainState", "save_checkpoint_orbax", "load_checkpoint_orbax"},
    "parallel": {"column_sharding", "batch_sharding", "replicated_sharding"},
}
#: flags that say whether a package's native library loads here: each
#: package builds its own (the JAX package's extension by setup.py, the
#: port's at first use), so their values may differ
BUILD_FLAGS = {"HAVE_NATIVE"}
SUBPACKAGES = ("cmf", "core", "detect", "flow", "masks", "models", "parallel", "qc",
               "train", "triage")


def _jax_names(sub):
    """The names the JAX subpackage's ``__init__`` imports from its modules."""
    with open(os.path.join(ROOT, "srcfinder_tpu", sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [a.name for n in tree.body if isinstance(n, ast.ImportFrom) and n.level == 1
            for a in n.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names_resolve(sub):
    port = importlib.import_module(f"srcfinder_torch.{sub}")
    jax_pkg = importlib.import_module(f"srcfinder_tpu.{sub}")
    names = [n for n in _jax_names(sub) if n not in LEFT_OUT.get(sub, ())]
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"srcfinder_torch.{sub} lacks {missing}"
    for n in names:
        got, ref = getattr(port, n), getattr(jax_pkg, n)
        # a function stays a function (not its module of the same name),
        # a constant equals the JAX package's
        assert callable(got) == callable(ref), n
        if n in BUILD_FLAGS:
            assert isinstance(got, bool) and isinstance(ref, bool), n
        elif isinstance(ref, (str, int, float, tuple, list, dict)) and not callable(ref):
            assert got == ref, n
    assert set(names) <= set(dir(port))


def test_colliding_names_stay_functions():
    """``filtdet``, ``googlenet`` and ``cluster`` name both a module and a
    function of it: the package's attribute is the function, also after
    the module is imported in a fresh process."""
    code = ("import importlib, srcfinder_torch.detect as d, srcfinder_torch.models as m, "
            "srcfinder_torch.flow as f\n"
            "for mod in ('detect.filtdet', 'models.googlenet', 'flow.cluster'):\n"
            "    importlib.import_module('srcfinder_torch.' + mod)\n"
            "assert callable(d.filtdet) and callable(m.googlenet) and callable(f.cluster)\n")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_version():
    assert srcfinder_torch.__version__ == srcfinder_tpu.__version__ == "0.1.0"


def test_models_helpers():
    from srcfinder_torch import models
    x = torch.linspace(-100, 5000, 12).reshape(1, 1, 3, 4)
    assert torch.equal(models.clamp_ch4(x), x.clamp(0, 4000))
    assert torch.equal(models.clamp_ch4(x, 10, 20), x.clamp(10, 20))
    y = torch.arange(2 * 3 * 14 * 14, dtype=torch.float64).reshape(2, 3, 14, 14)
    got = models.adaptive_avg_pool2d(y, (4, 4))
    ref = np.stack([np.stack([y[:, :, (i * 14) // 4:-(-((i + 1) * 14) // 4),
                                (j * 14) // 4:-(-((j + 1) * 14) // 4)].mean(dim=(2, 3)).numpy()
                              for j in range(4)], -1) for i in range(4)], -2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15)
    net = models.googlenet(dropout=0.0)
    assert net.aux_logits and net.num_classes == 2
    assert not models.googlenet(num_classes=3, aux_logits=False).aux_logits


def test_load_pt_matches_jax(tmp_path):
    """A .pt of seeded weights (the reference's torch names, aux heads
    included) gives the JAX package's Flax tree, leaf for leaf."""
    from srcfinder_torch import models
    gen = torch.Generator().manual_seed(0)
    net = models.googlenet()
    with torch.no_grad():
        for v in net.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=gen, dtype=v.dtype))
    path = str(tmp_path / "w.pt")
    torch.save(net.state_dict(), path)
    got, ref = models.load_pt(path), jconvert.load_pt(path)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    g, r = dict(leaves(got)), dict(leaves(ref))
    assert sorted(g) == sorted(r) and any(k[1] == "aux1" for k in g)
    for k in g:
        assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
        np.testing.assert_array_equal(g[k], r[k])
