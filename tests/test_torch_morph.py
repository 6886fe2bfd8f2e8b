"""The masks' dilations (``srcfinder_torch.ops.morph``): the plain version
held to ``scipy.ndimage.binary_dilation`` bit for bit on the CPU, and the
CUDA kernel (``csrc/morph.cu``) held to the plain version bit for bit on a
card.

``disk(r)`` is the flare growth's element and the taxicab ball of radius r
(r passes of the 3 x 3 cross) the cloud buffer's. The card tests skip
without a card. This file imports no JAX, so it runs where the card is,
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_morph.py
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from srcfinder_torch.core.morphology import disk
from srcfinder_torch.masks import sds
from srcfinder_torch.ops import morph

BLOCK = (554, 598)        # a mask block at 3.1 m: block_step 500 + ceil(5 + 49)
SCENE = (2801, 598)       # the cloud buffer's map, a 2801-line flightline


def _scipy(seeds, r, element):
    """What the masks computed with scipy: one dilation by disk(r), or r
    passes of the 3 x 3 cross."""
    seeds = np.asarray(seeds, bool)
    if element == "disk":
        return ndimage.binary_dilation(seeds, structure=disk(r, dtype=bool)) if r else seeds
    for _ in range(r):
        seeds = ndimage.binary_dilation(seeds)
    return seeds


def _plain(seeds, r, element):
    return morph.dilate(torch.from_numpy(np.ascontiguousarray(seeds, bool)), r, element).numpy()


def _edges(shape):
    """A seed on every corner and in the middle of every edge."""
    H, W = shape
    m = np.zeros(shape, bool)
    for y, x in [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1),
                 (0, W // 2), (H - 1, W // 2), (H // 2, 0), (H // 2, W - 1)]:
        m[y, x] = True
    return m


def _maps(shape, seed):
    """Seeded sparse and dense maps, and the edge seeds."""
    rng = np.random.default_rng(seed)
    return [rng.random(shape) < 0.002, rng.random(shape) < 0.2, _edges(shape)]


@pytest.mark.parametrize("r", [1, 2, 4, 49])
def test_disk_is_scipys_disk_dilation(r):
    for m in _maps((131, 97), r):
        np.testing.assert_array_equal(_plain(m, r, "disk"), _scipy(m, r, "disk"))


@pytest.mark.parametrize("r", [1, 5, 49])
def test_diamond_is_the_iterated_cross(r):
    for m in _maps((127, 93), 100 + r):
        np.testing.assert_array_equal(_plain(m, r, "diamond"), _scipy(m, r, "diamond"))


@pytest.mark.parametrize("r", [0, 1, 2, 4, 7, 49])
def test_halfwidths_are_the_elements_rows_and_columns(r):
    """Row k and column k of disk(r) are |dx| <= isqrt(r^2 - k^2); of r
    passes of the cross (the dilation of one pixel), |dx| <= r - k."""
    dx = np.abs(np.arange(-r, r + 1))
    one = np.zeros((2 * r + 1, 2 * r + 1), bool)
    one[r, r] = True
    for element, want in [("disk", disk(r, dtype=bool)), ("diamond", _scipy(one, r, "diamond"))]:
        hw = morph.halfwidths(element, r)
        got = np.array([dx <= hw[k] for k in dx])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.T, want)


CASES = {
    "empty": lambda: np.zeros((40, 50), bool),
    "all-ones": lambda: np.ones((40, 50), bool),
    "edges-and-corners": lambda: _edges((40, 50)),
    "radius-past-the-map": lambda: _edges((9, 12)),
    "one-row": lambda: np.random.default_rng(1).random((1, 70)) < 0.05,
    "one-column": lambda: np.random.default_rng(2).random((70, 1)) < 0.05,
    "one-pixel": lambda: np.ones((1, 1), bool),
    "block-one-core": lambda: np.pad(np.ones((4, 4), bool), ((300, 250), (200, 394))),
}


@pytest.mark.parametrize("element", ["disk", "diamond"])
@pytest.mark.parametrize("case", list(CASES))
def test_edge_cases_equal_scipy(case, element):
    m = CASES[case]()
    r = 49 if m.shape != (9, 12) else 30
    if case.startswith("block"):
        assert m.shape == BLOCK
    np.testing.assert_array_equal(_plain(m, r, element), _scipy(m, r, element))


@pytest.mark.parametrize("element", ["disk", "diamond"])
def test_block_shape_at_the_cells_radius(element):
    """The masks cell's shape and radius, with seeds at a flightline's
    density of flare and cloud pixels and on every edge."""
    m = (np.random.default_rng(49).random(BLOCK) < 1e-4) | _edges(BLOCK)
    np.testing.assert_array_equal(_plain(m, 49, element), _scipy(m, 49, element))


def test_uint8_seeds_and_empty_maps():
    m = np.random.default_rng(3).random((30, 40)) < 0.02
    got = morph.dilate(torch.from_numpy(m.astype(np.uint8) * 7), 4, "disk")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), _scipy(m, 4, "disk"))
    for shape in [(0, 5), (5, 0)]:
        assert morph.dilate(torch.zeros(shape, dtype=torch.bool), 3, "disk").shape == shape


@pytest.mark.parametrize("args,err", [((torch.zeros(2, 3, 4, dtype=torch.bool), 1, "disk"),
                                       ValueError),
                                      ((torch.zeros(3, 4, dtype=torch.bool), 1, "square"),
                                       ValueError),
                                      ((torch.zeros(3, 4, dtype=torch.bool), -1, "disk"),
                                       ValueError)])
def test_dilate_rejects(args, err):
    with pytest.raises(err):
        morph.dilate(*args)


def test_masks_growth_and_buffer_equal_scipys():
    """sds.grow_flare_mask and sds.dilate_mask on the CPU against the
    scipy formulas they replaced, at the masks cell's block and radius."""
    rng = np.random.default_rng(554)
    sat = np.zeros(BLOCK, bool)
    sat[100:104, 50:54] = sat[400:406, 590:598] = sat[0:3, 0:2] = True   # 3 kept, 1 under 5 px
    sat[300, 300] = True
    veto = np.zeros(BLOCK, bool)
    veto[400:403] = True
    spec = rng.random(BLOCK) < 0.5
    want = np.zeros(BLOCK, np.uint8)
    lab = ndimage.label(sat, structure=np.ones((3, 3)))[0]
    keep = np.bincount(lab.ravel()) >= 5
    keep[0] = False
    want[_scipy(keep[lab] & ~veto, 49, "disk")] = 2
    want[sat & ~spec] = 1
    np.testing.assert_array_equal(sds.grow_flare_mask(sat, spec, veto, 49.0, 5), want)
    cloud = rng.random(SCENE) < 2e-4
    np.testing.assert_array_equal(sds.dilate_mask(cloud, 48.4), _scipy(cloud, 49, "diamond"))


# ---- the kernel on a card ------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dilation kernel has no CPU version")
    return torch.device("cuda")


@pytest.mark.parametrize("density", [0.0, 1e-4, 1e-2, 0.5, 1.0])
@pytest.mark.parametrize("shape,element", [(BLOCK, "disk"), (SCENE, "diamond")],
                         ids=["block-disk", "scene-diamond"])
def test_kernel_equals_plain(card, shape, element, density):
    """At the masks cell's shapes and radius: the kernel's map equals the
    plain version's bit for bit, two launches agree, and each launch
    counts once under its element."""
    m = np.random.default_rng(int(density * 1e4) + shape[0]).random(shape) < density
    seeds = torch.from_numpy(m).to(card)
    before = morph.launches()[element]
    got = morph.dilate(seeds, 49, element)
    assert morph.launches()[element] - before == 1
    assert got.dtype == torch.bool and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), _plain(m, 49, element))
    assert torch.equal(morph.dilate(seeds, 49, element), got)
    assert morph.launches()[element] - before == 2


@pytest.mark.parametrize("element", ["disk", "diamond"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_edge_cases(card, case, element):
    m = CASES[case]()
    r = 49 if m.shape != (9, 12) else 30
    got = morph.dilate(torch.from_numpy(m.astype(np.uint8)).to(card), r, element)
    np.testing.assert_array_equal(got.cpu().numpy(), _scipy(m, r, element))


def test_a_cuda_tensor_never_reaches_the_plain_version(card, monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(morph, "dilate_ref", plain)
    m = _edges(BLOCK)
    got = morph.dilate(torch.from_numpy(m).to(card), 49, "disk")
    np.testing.assert_array_equal(got.cpu().numpy(), _scipy(m, 49, "disk"))
    cloud = np.random.default_rng(5).random((300, 200)) < 1e-3
    assert (sds.dilate_mask(cloud, 49, device=card) == _scipy(cloud, 49, "diamond")).all()
    with pytest.raises(ValueError):
        morph.dilate(torch.zeros(4, 8, dtype=torch.bool, device=card).t(), 2, "disk")
