"""The port's spectrometer masks (srcfinder_torch.masks.cli.masks_for_flightline)
held to the benchmark's plain reference (portbench/reference/masks.py) on the
CPU, pixel for pixel.

The reference follows masks_sds.py's semantics with its own morphology: the
flare growth as a Euclidean distance transform and the cloud buffer as a
taxicab one. The scene is a seeded 700 x 32 x 425 cube streamed in 100-line
blocks (13 lines of overlap at an 8 px grow radius and mingrowarea 5) with
the cases that the blocks make hard: flares across a block boundary (one
under mingrowarea in the earlier block), a flare inside an overlap, a flare
under mingrowarea, glint vetoed whole and in part, clouds at the image's
edges with their shadows, a flare in the padded last block, and nodata.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from portbench.reference import masks as ref
from srcfinder_torch.core.envi import open_envi, save_envi
from srcfinder_torch.core.morphology import disk
from srcfinder_torch.masks import cli, sds

torch.set_num_threads(1)

L, C, B = 700, 32, 425
WL = np.array([float(f"{w:.2f}") for w in np.linspace(380, 2510, B)])
META = {"data ignore value": -9999,
        "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1", "11",
                     "North", "WGS-84", "units=Meters", "rotation=0"],
        "wavelength": [f"{w:.2f}" for w in WL]}
GROW, CLOUD_BUFFER, MINAREA, STEP = 8, 5, 5, 100
SWIR = (WL >= 1945) & (WL <= 2485)
VIS = np.argmin(np.abs(WL - 505))
CLOUD = np.interp(WL, [WL[np.argmin(np.abs(WL - nm))] for nm in (450, 670, 1250)] + [1900, 2510],
                  [20, 16, 8, 5, 3])


def _disc(line, sample, radius):
    rr, cc = np.mgrid[:L, :C]
    return (rr - line) ** 2 + (cc - sample) ** 2 <= radius * radius


def scene(seed):
    """The seeded cube (lines, samples, bands) with the planted cases."""
    rng = np.random.default_rng(seed)
    x = (np.abs(rng.normal(4.0, 0.2, (L, C, B))) + 0.5).astype(np.float32)
    hot = np.where(SWIR, 12.0, 1.0).astype(np.float32)
    for (r0, r1), (c0, c1) in [((210, 216), (5, 8)),     # across 200/213: 9 px in block 1
                               ((211, 217), (20, 22)),   # across: 4 px in block 1, 12 in 2
                               ((304, 308), (12, 16)),   # inside the overlap 300-313
                               ((420, 422), (25, 27)),   # 4 px, under mingrowarea
                               ((540, 546), (20, 26)),   # glint on its top half
                               ((695, 699), (28, 32))]:  # in the padded last block
        x[r0:r1, c0:c1] = np.where(SWIR, 12.0, x[r0:r1, c0:c1])
    x[520:526, 3:9] = 12.0 * hot / hot                  # glint: every band 12
    x[540:543, 20:26, VIS] = 12.0
    for line, sample, radius in [(650, 0, 6), (0, 20, 5), (120, 31, 7)]:
        x[_disc(line + 8, sample + 4, radius)] = 0.08  # shadow, then its cloud
        x[_disc(line, sample, radius)] = CLOUD
    for r, c in [(0, 0), (350, 31), (690, 10), (690, 11), (690, 12)]:
        x[r, c] = -9999.0
    return x


@pytest.fixture(scope="module", params=[3, 2 ** 31 + 9])
def masks(request, tmp_path_factory):
    """(port's mask, reference's mask, reference's grown blocks)."""
    d = tmp_path_factory.mktemp("maskref")
    x = scene(request.param)
    rdn = str(d / "ang20190801t160000_rdn_v2y1_img")
    save_envi(rdn + ".hdr", x, metadata=META, interleave="bil")
    name = cli.masks_for_flightline(rdn + ".hdr", str(d), cldbfr=f"{CLOUD_BUFFER}px",
                                    maskgrowradius=f"{GROW}px", mingrowarea=MINAREA,
                                    block_step=STEP, device="cpu")
    got = open_envi(str(d / name)).load()
    want, grown = ref.flightline_masks(lambda r0, r1, idx: x[r0:r1][..., idx], L, C, WL,
                                       grow_px=GROW, cldbfr_px=CLOUD_BUFFER,
                                       mingrowarea=MINAREA, block_step=STEP)
    return got, want, grown


def test_port_masks_equal_the_reference(masks):
    got, want, _ = masks
    assert got.shape == want.shape == (L, C, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_the_planted_cases_are_exercised(masks):
    """Each case does what it is planted for, so that the equality above
    holds where the blocks matter."""
    _, want, grown = masks
    flare = want[..., 2]
    assert grown == [1, 2, 3, 5, 6]
    assert (flare[213:216, 20:22] == 1).all() and flare[219, 21] == 2  # grown in block 2
    assert flare[300, 14] == 2 and flare[312, 14] == 2                # overlap, both blocks
    assert (flare[420:422, 25:27] == 1).all() and not (flare[410:432, 15:32] == 2).any()
    assert (want[520:526, 3:9, 1] == 1).all() and not (flare[510:536, :20] == 2).any()
    assert (want[540:543, 20:26, 1] == 1).all() and flare[550, 22] == 2
    assert flare[698, 29] == 1 and flare[690, 29] == 2
    assert want[650, 0, 0] == 1 and want[650 + 6 + CLOUD_BUFFER, 0, 0] == 1
    assert want[0, 20, 0] == 1 and want[663, 4, 3] == 1
    assert (want[[0, 350, 690], [0, 31, 11]] == -9999).all()
    assert all((want[..., b] == 1).any() for b in range(4))


@pytest.mark.parametrize("radius", [1, 4, 49])
def test_edt_growth_is_the_disk_dilation(radius):
    rng = np.random.default_rng(radius)
    sat = rng.random((120, 90)) < 0.004
    glint = np.zeros_like(sat)
    want = sds.grow_flare_mask(sat, glint, glint, radius, 0)
    got, seeded = ref.flare_block(sat, glint, glint, radius, 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got >= 1, ndimage.binary_dilation(sat, structure=disk(
        radius, dtype=bool)))
    assert seeded


@pytest.mark.parametrize("radius", [1, 5, 49])
def test_taxicab_buffer_is_the_iterated_cross(radius):
    rng = np.random.default_rng(radius)
    cloud = rng.random((130, 70)) < 0.002
    np.testing.assert_array_equal(ref.buffer(cloud, radius), sds.dilate_mask(cloud, radius))
