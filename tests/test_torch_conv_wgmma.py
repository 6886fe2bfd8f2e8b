"""The bf16 convolution kernel on a card (``conv_wgmma_kernel`` of
``srcfinder_torch/ops/csrc/trunk.cu``, through ``trunk_fuse.conv`` and the
segments), against the plain conv in bf16 (``trunk_fuse._conv_ref``).

The kernel has no CPU version, so every test here skips without a card.
This file imports no JAX, so it runs where the card is, without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_conv_wgmma.py

Covered: each tile width the bf16 rule picks (``conv_tile_width``: 32 to
256), 1x1 convs (A by TMA) and 3x3 convs (A by cp.async, padding at the
map's edges), channel slices with offsets and pixel strides, a channel
split into two maps, M off the 128-row tile, two column tiles, a grid of
persistent blocks with unequal tile counts, repeats bit for bit, and
``conv_launches`` counting every conv of the stage12 route's segments.
"""

import collections
import math

import pytest
import torch

from srcfinder_torch.ops import trunk_fuse as tf

BF16 = torch.bfloat16
TOL = 2e-2      # max |kernel - plain| / max |plain|: bf16 outputs, sums in another order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bf16 conv kernel has no CPU version")
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _maps(dev, n, side, cin, cout, k, split, seed):
    """Seeded input map (a channel slice at offset 8 of a map 16 channels
    wider), weights, bias and NaN-filled outputs: y0 the first ``split``
    channels at offset 8 of a wider map, y1 the rest at offset 0 of
    another (None without a split)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(n, side, side, cin + 16, generator=g, device=dev).relu_().to(BF16)
    ks = (cin, cout) if k == 1 else (k, k, cin, cout)
    w = (torch.randn(ks, generator=g, device=dev) * (k * k * cin) ** -0.5).to(BF16)
    b = (torch.randn(1, cout, generator=g, device=dev) * 0.2).to(BF16)
    Y0 = torch.full((n, side, side, split + 24), float("nan"), device=dev, dtype=BF16)
    Y1 = (torch.full((n, side, side, cout - split), float("nan"), device=dev, dtype=BF16)
          if split < cout else None)
    return X, w, b, Y0, Y1


# (tile width, cout, k, cin, split, windows, side): each width of the rule
# once, M off the 128-row tile in every case
CASES = [(32, 32, 3, 16, 32, 3, 7),
         (64, 48, 3, 24, 48, 2, 9),
         (96, 96, 3, 32, 40, 3, 7),
         (128, 128, 1, 528, 128, 5, 5),
         (160, 288, 3, 144, 288, 2, 9),     # two column tiles
         (192, 176, 1, 192, 64, 3, 11),     # inception3a.wide: 64 to y0, 112 to y1
         (224, 448, 1, 832, 256, 4, 5),     # inception5a.wide, two column tiles
         (256, 256, 3, 128, 256, 2, 6)]


@pytest.mark.parametrize("width,cout,k,cin,split,n,side", CASES,
                         ids=[f"w{c[0]}-k{c[2]}" for c in CASES])
def test_conv_bf16_kernel_matches_plain(card, width, cout, k, cin, split, n, side):
    """One conv at each tile width against the plain conv in bf16: the
    dispatch picks the rule's width, the outputs land in their channel
    slices and nowhere else, two launches give the same bits, and each
    launch counts under its width."""
    X, w, b, Y0, y1 = _maps(card, n, side, cin, cout, k, split, seed=width)
    x, y0 = X[..., 8:8 + cin], Y0[..., 8:8 + split]
    pad = k // 2
    assert tf.conv_tile_width(cout) == width
    assert tf.conv_tile(x, w, b, y0, y1, 1, pad) == width
    assert (n * side * side) % 128
    before = tf.conv_launches().get(width, 0)
    tf.conv(x, w, b, y0, y1, 1, pad)
    got = y0.clone() if y1 is None else torch.cat([y0, y1], 3)
    tf.conv(x, w, b, y0, y1, 1, pad)
    again = y0 if y1 is None else torch.cat([y0, y1], 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert tf.conv_launches().get(width, 0) - before == 2
    ref = tf._nhwc(tf._conv_ref(tf._nchw(x), w, b, 1, pad))
    assert _rel(got, ref) <= TOL
    assert torch.isnan(Y0[..., :8]).all() and torch.isnan(Y0[..., 8 + split:]).all()
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("cout,k", [(192, 3), (320, 1)], ids=["k3-one-tile", "k1-two-tiles"])
def test_conv_bf16_kernel_unequal_persistent_tiles(card, cout, k):
    """More tiles than blocks, not a multiple of the card's SMs: some
    persistent blocks take one tile more than others, and the ring runs
    on across tiles; the result still matches the plain conv, bit for
    bit on a repeat."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    n, side, cin = 2 * sms + 3, 8, 64           # M = 64 n: n / 2 + 1 row tiles
    X, w, b, Y0, _ = _maps(card, n, side, cin, cout, k, cout, seed=cout)
    x, y0 = X[..., 8:8 + cin], Y0[..., 8:8 + cout]
    tiles = -(-n * side * side // 128) * -(-cout // tf.conv_tile_width(cout))
    assert tiles > sms and tiles % sms
    tf.conv(x, w, b, y0, None, 1, k // 2)
    got = y0.clone()
    tf.conv(x, w, b, y0, None, 1, k // 2)
    torch.cuda.synchronize()
    assert torch.equal(got, y0)
    assert _rel(got, tf._nhwc(tf._conv_ref(tf._nchw(x), w, b, 1, k // 2))) <= TOL


def _params(dev, name, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tf.pack_params(name, [(torch.randn(s, generator=g, device=dev)
                                  * (0.2 if s[0] == 1 else math.prod(s[:-1]) ** -0.5)).to(BF16)
                                 for s in tf._SHAPES[name]])


def test_conv_launches_count_the_stage12_route(card):
    """fused_stage12, trunk_s3 and trunk_s45 in bf16 on 3 windows of 64 x
    64, as the stage12 route chains them: conv_launches counts every conv
    of their conv_plan under the width conv_tile_width gives, and each
    segment matches its plain version."""
    d, n = 64, 3
    g = torch.Generator(device=card).manual_seed(64)
    wins = torch.randn(n, d, d, 1, generator=g, device=card).to(BF16)
    p12, p3, p45 = (_params(card, name, i) for i, name in
                    enumerate(("fused_stage12", "trunk_s3", "trunk_s45")))
    want = collections.Counter(tf.conv_tile_width(c.cout) for name, side in (
        ("fused_stage12", d), ("trunk_s3", d // 8), ("trunk_s45", d // 16))
        for c in tf.conv_plan(name, side))
    tf.KERNEL.reset()
    with torch.no_grad():
        x12 = tf.fused_stage12(wins, p12)
        x3 = tf.trunk_s3(x12, p3)
        x45 = tf.trunk_s45(x3, p45)
        torch.cuda.synchronize()
        assert tf.conv_launches() == dict(want)
        assert [tf.launches(k) for k in ("fused_stage12", "trunk_s3", "trunk_s45")] == [1, 1, 1]
        for got, ref in ((x12, tf.fused_stage12_ref(wins, p12)), (x3, tf.trunk_s3_ref(x12, p3)),
                         (x45, tf.trunk_s45_ref(x3, p45))):
            assert _rel(got, ref) <= TOL
    tf.KERNEL.reset()
    assert tf.conv_launches() == {}
