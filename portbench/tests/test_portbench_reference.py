"""The plain reference against the port's CPU path at tiny sizes: the CMF's
columns, one GoogLeNet-1ch window, the literal shift-and-stitch FCN, and the
plume candidates and IME table of a small map. (The test imports both; the
reference imports neither.)"""

import ast
import os

import numpy as np
import pandas as pd
import torch

from conftest import REPO
from portbench.drivers import flightline as fl
from portbench.drivers.exact_cnn import reference_windows
from portbench.inputs import seeded_state_dict
from portbench.reference import cmf as ref_cmf
from portbench.reference import post
from portbench.reference.googlenet import GoogLeNet1ch

GEO = dict(ulx=272247.15, uly=3992010.65, ps=3.1, zone=11, north=True)
MAPINFO = {"proj": "UTM", "ulx": 272247.15, "uly": 3992010.65, "xps": 3.1, "yps": 3.1,
           "zone": "11", "hemi": "North", "rotation": 0.0}


def test_the_reference_imports_no_program_and_no_jax():
    for name in os.listdir(os.path.join(REPO, "portbench", "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REPO, "portbench", "reference", name)).read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        tops = {m.split(".")[0] for m in mods}
        assert not tops & {"jax", "jaxlib", "flax", "srcfinder_tpu", "srcfinder_torch"}, name


def test_cmf_columns_match_the_port():
    from srcfinder_torch.cmf import matched_filter as mfmod
    g = torch.Generator().manual_seed(5)
    L, C, B = 300, 6, 72
    x = (torch.randn(L, C, B, generator=g, dtype=torch.float64) * 0.5 + 4.0).abs() + 0.5
    x[100:120, 2, 20:60] *= 0.9
    x[::37, :, 3] = -1.0
    absorption = -torch.rand(B, generator=g, dtype=torch.float64) * 0.1
    want, valid = ref_cmf.matched_filter(x, absorption.numpy())
    m = mfmod.valid_mask(x)
    res = mfmod.matched_filter_columns(x, m.double(), absorption,
                                       torch.as_tensor(mfmod.default_alphas()))
    assert torch.equal(valid, m)
    got = res.mf * mfmod.PPM_SCALING
    assert (got[valid] - want[valid]).abs().max() <= 1e-9 * want.abs().max()


def test_one_window_matches_the_port():
    from srcfinder_torch.models.googlenet import GoogLeNet
    sd = seeded_state_dict(11, "cpu", {"bn": "trained_like", "conv_gain": 1.0, "fc_gain": 4.0})
    ref = GoogLeNet1ch()
    ref.load_state_dict(sd)
    port = GoogLeNet(num_classes=2)
    port.load_state_dict(sd)
    x = torch.randn(1, 1, 256, 256, generator=torch.Generator().manual_seed(1)) * 250
    x[..., 100:140, 90:150] += 2500
    x = (x.clamp(0, 4000) - 110.6390) / 183.9152
    with torch.no_grad():
        want = torch.softmax(port.eval()(x), dim=-1)[:, 1]
        got = ref.eval().probability(x)
    assert abs(float(got - want)) < 1e-5 and 0.01 < float(want) < 0.99


def test_sampled_windows_match_the_ports_exact_cnn():
    from srcfinder_torch.detect.cnn_pipeline import cnn_saliency_image
    from srcfinder_torch.models.googlenet import GoogLeNet
    sd = seeded_state_dict(4, "cpu", {"bn": "trained_like", "conv_gain": 1.0, "fc_gain": 4.0})
    port = GoogLeNet(num_classes=2)
    port.load_state_dict(sd)
    band = np.random.default_rng(0).normal(0, 400, (3, 5)).astype(np.float32)
    got = cnn_saliency_image(band, port, dim=64, batch=4, device="cpu").numpy()
    ref = GoogLeNet1ch()
    ref.load_state_dict(sd)
    picks = np.array([0, 6, 14])
    want = reference_windows(ref.eval(), band, picks, 110.6390, 183.9152, 64, "cpu")
    assert np.abs(got.ravel()[picks] - want).max() < 1e-5


def test_shift_saliency_matches_the_ports_shift_path():
    from srcfinder_torch.detect.fcn_pipeline import fcn_saliency_image, saliency_model
    sd = seeded_state_dict(3, "cpu", {"bn": "trained_like", "conv_gain": 1.0, "fc_gain": 2.0})
    band = np.random.default_rng(1).normal(0, 3000, (40, 36)).astype(np.float32)
    band[0, :2] = -9999.0
    got = fcn_saliency_image(band, saliency_model(sd, device="cpu"), method="shift",
                             device="cpu").numpy()
    shifts = [(0, 0), (31, 31), (5, 17), (16, 2)]
    for r, c, want in fl.shift_saliency(fl.reference_model(sd, "cpu"), band, 115.0, 190.0,
                                        shifts, "cpu"):
        keep = band[np.ix_(r, c)] != -9999.0
        assert np.abs(got[np.ix_(r, c)][keep] - want[keep]).max() < 1e-5


def sparse_map(seed=0):
    rng = np.random.default_rng(seed)
    cmf = rng.normal(0, 300, (120, 90)).astype(np.float32)
    for r, c in ((20, 20), (24, 30), (80, 60)):
        cmf[r:r + 6, c:c + 5] = 3000 + rng.normal(0, 200, (6, 5))
    cmf[0, :3] = -9999.0
    return cmf


def test_candidates_match_the_ports_salience():
    from srcfinder_torch.detect.salience import salience2detections, save_detections
    cmf = sparse_map()
    sal = np.clip(np.abs(cmf) / 4000, 0, 1).astype(np.float32)
    rgb0 = np.where(cmf == -9999.0, -9999.0, 1.0)
    cmfimg = np.stack([rgb0, rgb0, rgb0, cmf.astype(np.float64)], axis=-1)
    df = salience2detections(sal, cmfimg, 0.5, 250.0, "ang20200924t211102", MAPINFO)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        csvf = save_detections(os.path.join(d, "x.xlsx"), df)
        got = pd.read_csv(csvf).values.tolist()
    want = post.candidates(sal, cmfimg[..., 3], rgb0, 0.5, 250.0, "ang20200924t211102", GEO)
    assert len(want) >= 2
    from portbench.checks import table_gap
    assert table_gap(got, want) < 1e-12


def test_ime_table_matches_the_ports_ime():
    from srcfinder_torch.flow.ime_worker import detection_ime_stats
    from portbench.checks import table_gap
    cmf = sparse_map(1)
    got = detection_ime_stats(cmf, MAPINFO).values.tolist()
    want = post.ime_table(cmf, GEO)
    assert len(want) == 3 * 2 or len(want) >= 3
    assert table_gap(got, want) < 1e-6


def test_a_merge_that_covers_the_scene_gives_no_rows_in_both():
    """Plumes 20 px apart on a 40 x 40 map: at 50 m (16 px) the merged region
    covers every pixel, and mergelabels keeps no region of that distance."""
    from srcfinder_torch.flow.ime_worker import detection_ime_stats
    from portbench.checks import table_gap
    cmf = np.full((40, 40), 100.0, np.float32)
    for r, c in ((8, 8), (8, 28), (28, 8), (28, 28)):
        cmf[r:r + 4, c:c + 4] = 3000.0
    got = detection_ime_stats(cmf, MAPINFO).values.tolist()
    want = post.ime_table(cmf, GEO)
    assert {row[0] for row in want} == {10, 20} and len(want) >= 2
    assert table_gap(got, want) < 1e-6
