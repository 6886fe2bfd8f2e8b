"""The frozen counts: FLOPs per window, the peaks, the CMF kernels' bounds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import cmf_kernels, work
from portbench.reference.googlenet import GoogLeNet1ch


def test_window_flops_are_flop_counter_mode_on_the_plain_network():
    with torch.device("meta"):
        model = GoogLeNet1ch()
        x = torch.empty(2, 1, 256, 256)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.probability(x)
    assert work.window_flops(256) == counter.get_total_flops() // 2
    assert work.window_flops(256) == pytest.approx(3.706e9, rel=1e-3)
    assert work.trunk_flops(256) == work.window_flops(256) - 2 * 1024 * 2


def test_peaks_have_no_implementation_factor():
    assert work.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12, "float64": 67e12}
    assert work.PEAK_BYTES == 3.35e12
    n = 76_544
    ops = n * work.trunk_flops(256)
    assert work.trunk_bound_s(n, 256, "float32", 150) == pytest.approx(ops / 495e12)
    assert work.trunk_bound_s(n, 256, "bfloat16", 19) == pytest.approx(ops / 989e12)


def test_cmf_kernel_bounds_follow_the_smoke_tests_arithmetic():
    L, C, B, A, s = 2801, 256, 72, 201, 4
    # chip_smoke.py cmf_kernel_checks: K1 and K2 at one column chunk
    k1_bytes = s * (L * C * B + L * C + C + C * B + C * B * B)
    k1_ops = L * C * B * (B + 1) + 4 * L * C * B + L * C
    k2_bytes = s * (L * C * B + C * B * A + C * A + L * C + C * A) + C * A
    k2_ops = 2 * L * C * B * A + 7 * L * C * A
    assert work.k1_work(L, C, B, s) == (k1_ops, k1_bytes)
    assert work.k2_work(L, C, B, A, s) == (k2_ops, k2_bytes)
    cfg = {"lines": L, "samples": 598, "active_bands": [351, 422], "alphas": A}
    traffic = {"col_chunk": C, "cmf_dtype": "float32"}
    k1 = max(k1_ops / 67e12, k1_bytes / 3.35e12)
    assert cmf_kernels.nominal_bound_s(cfg, traffic, "k1") == pytest.approx(3 * k1)
    k2 = max(k2_ops / 67e12, k2_bytes / 3.35e12)
    assert cmf_kernels.nominal_bound_s(cfg, traffic, "k2") == pytest.approx(3 * k2)


def test_the_dense_fcn_count_covers_every_canvas_pixel():
    h, w = work.canvas_shape(2801, 598)
    assert (h, w) == (2880, 672)
    per_pixel = work.fcn_dense_flops(64, 64) / (work.canvas_shape(64, 64)[0]
                                                * work.canvas_shape(64, 64)[1])
    assert work.fcn_dense_flops(2801, 598) == pytest.approx(per_pixel * h * w, rel=1e-9)
