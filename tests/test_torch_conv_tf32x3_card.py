"""The f32 convolution kernel on a card (``conv_tf32x3_kernel`` and its
weight split ``conv_tf32x3_kernel_split`` in
``srcfinder_torch/ops/csrc/trunk.cu``, through ``trunk_fuse.conv`` and the
segments), against the plain conv in f32
(``trunk_fuse._conv_ref``, cuDNN with TF32 off) and in f64.

The kernel has no CPU version, so every test here skips without a card;
``tests/test_torch_conv_tf32x3.py`` holds its arithmetic on the CPU. This
file imports no JAX, so it runs where the card is, without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_conv_tf32x3_card.py

Covered: every distinct f32 conv shape of the four plans
(``trunk_fuse.conv_plan``: P2's conv3, trunk_s23, trunk_s3, trunk_s45; 34)
laid out as its segment lays it (channel offsets, pixel strides, the
channel split), at the width ``conv_tile_width`` gives, within TRUNK_TOL of
the plain f32 conv and 1e-6 of the f64 conv, repeats bit for bit; the split
weights equal to ``trunk_fuse.split_tf32``'s bit for bit; a grid of
persistent blocks with unequal tile counts; and ``conv_launches`` counting
every f32 conv of a ``trunk_s45`` call at its plan's widths.
"""

import collections
import math

import pytest
import torch

from srcfinder_torch.ops import trunk_fuse as tf

F32 = torch.float32
TRUNK_TOL = 1e-5   # max |kernel - plain| / max |plain|: the f32 trunk's tolerance
EXACT = 1e-6       # max |kernel - f64 conv| / max |f64 conv|: 3xTF32 keeps f32's digits
WIN = 256          # the window side the segments run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the f32 conv kernel has no CPU version")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _f32_convs():
    """The distinct f32 convs of the segments' plans at the card's window
    side, each with its segment's channel layout."""
    out, seen = [], set()
    for name, side in (("fused_stage12", WIN), ("trunk_s23", WIN // 2), ("trunk_s3", WIN // 8),
                       ("trunk_s45", WIN // 16)):
        for c in tf.conv_plan(name, side):
            key = (c.side, c.cin, c.cout, c.k, c.stride, c.pad)
            if key not in seen:
                seen.add(key)
                out.append(pytest.param(c, id=f"{name}-{c.layer}"))
    return out


def _rel(got, ref):
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def _maps(dev, c, n, seed):
    """Seeded input map, weights, bias and NaN-filled outputs of conv ``c``
    over ``n`` windows, laid out as ``c`` says."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fan_in = c.k * c.k * c.cin
    X = torch.randn(n, c.side, c.side, c.ldx, generator=g, device=dev).relu_()
    ks = (c.cin, c.cout) if c.k == 1 else (c.k, c.k, c.cin, c.cout)
    w = torch.randn(ks, generator=g, device=dev) * fan_in ** -0.5
    b = torch.randn(1, c.cout, generator=g, device=dev) * 0.2
    ho = (c.side + 2 * c.pad - c.k) // c.stride + 1
    Y0 = torch.full((n, ho, ho, c.ldy0), float("nan"), device=dev)
    Y1 = (torch.full((n, ho, ho, c.ldy1), float("nan"), device=dev)
          if c.split < c.cout else None)
    x = X[..., c.x_off:c.x_off + c.cin]
    y0 = Y0[..., c.y_off:c.y_off + c.split]
    y1 = None if Y1 is None else Y1[..., :c.cout - c.split]
    return x, w, b, Y0, Y1, y0, y1


@pytest.mark.parametrize("c", _f32_convs())
def test_conv_f32_kernel_matches_plain(card, c):
    """One f32 conv shape of the plans, as its segment lays it out: the
    dispatch picks the rule's width and counts both launches under it, the
    outputs match the plain f32 conv within TRUNK_TOL and the f64 conv
    within 1e-6, a repeat gives the same bits, and every channel the conv
    does not own stays NaN."""
    n = 3 if c.side <= 16 else 1                # 3 windows of 8 x 8: a ragged row tile
    x, w, b, Y0, Y1, y0, y1 = _maps(card, c, n, seed=c.side * 1000 + c.cin + c.cout)
    width = tf.conv_tile_width(c.cout, F32)
    assert tf.conv_tile(x, w, b, y0, y1, c.stride, c.pad) == width
    before = tf.conv_launches(F32).get(width, 0)
    tf.conv(x, w, b, y0, y1, c.stride, c.pad)
    got = y0.clone() if y1 is None else torch.cat([y0, y1], 3)
    tf.conv(x, w, b, y0, y1, c.stride, c.pad)
    again = y0 if y1 is None else torch.cat([y0, y1], 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert tf.conv_launches(F32).get(width, 0) - before == 2
    xt = tf._nchw(x)
    ref = tf._nhwc(tf._conv_ref(xt, w, b, c.stride, c.pad))
    ref64 = tf._nhwc(tf._conv_ref(xt.double(), w.double(), b.double(), c.stride, c.pad))
    assert _rel(got, ref) <= TRUNK_TOL
    assert _rel(got, ref64) <= EXACT
    untouched = int(torch.isnan(Y0).sum()) + (0 if Y1 is None else int(torch.isnan(Y1).sum()))
    assert untouched == Y0.numel() + (0 if Y1 is None else Y1.numel()) - got.numel()
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("shape", [(64, 96), (3, 3, 144, 288), (3, 3, 16, 32)],
                         ids=["1x1", "3x3-wide", "3x3-narrow"])
def test_split_kernel_matches_split_tf32(card, shape):
    """The scratch the f32 conv splits its weights into holds hi and lo as
    trunk_fuse.split_tf32 computes them, bit for bit: (cout, Kd) each,
    K-major."""
    k = shape[0] if len(shape) == 4 else 1
    cin, cout = shape[-2:]
    g = torch.Generator(device=card).manual_seed(cin + cout)
    x = torch.randn(1, 5, 5, cin, generator=g, device=card)
    w = torch.randn(shape, generator=g, device=card)
    b = torch.zeros(1, cout, device=card)
    y = torch.empty(1, 5, 5, cout, device=card)
    split = torch.full((2 * w.numel(),), float("nan"), device=card)
    args = tf._conv_args(x, w, b, y, None, 1, k // 2)
    tf.KERNEL.launch("srcf_conv_f32", *args, split.data_ptr(),
                     torch.cuda.current_stream(card).cuda_stream)
    torch.cuda.synchronize()
    hi, lo = tf.split_tf32(w)
    assert hi.shape == (cout, k * k * cin)
    assert torch.equal(split.view(2, cout, -1).view(torch.int32),
                       torch.stack([hi, lo]).view(torch.int32))


@pytest.mark.parametrize("cout,k", [(192, 3), (320, 1)], ids=["k3-two-tiles", "k1-three-tiles"])
def test_conv_f32_kernel_unequal_persistent_tiles(card, cout, k):
    """More tiles than blocks, not a multiple of the card's SMs: some
    persistent blocks take one tile more than others, and the ring runs on
    across tiles; the result still matches the plain conv, bit for bit on
    a repeat."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    n, side, cin = 2 * sms + 3, 8, 64            # M = 64 n: n / 2 + 1 row tiles
    c = tf.ConvLaunch("case", side, cin, cin + 16, 8, cout, k, 1, k // 2, cout + 24, 8, cout,
                      cout)
    x, w, b, _, _, y0, _ = _maps(card, c, n, seed=cout)
    tiles = -(-n * side * side // 128) * -(-cout // tf.conv_tile_width(cout, F32))
    assert tiles > sms and tiles % sms
    tf.conv(x, w, b, y0, None, 1, k // 2)
    got = y0.clone()
    tf.conv(x, w, b, y0, None, 1, k // 2)
    torch.cuda.synchronize()
    assert torch.equal(got, y0)
    assert _rel(got, tf._nhwc(tf._conv_ref(tf._nchw(x), w, b, 1, k // 2))) <= TRUNK_TOL


def test_conv_launches_count_trunk_s45_f32(card):
    """trunk_s45 in f32 on 3 windows of 16 x 16 maps: conv_launches(F32)
    counts every conv of its conv_plan under the width conv_tile_width
    gives (none in bf16), and the segment matches its plain version."""
    g = torch.Generator(device=card).manual_seed(45)
    p = tf.pack_params("trunk_s45", [torch.randn(s, generator=g, device=card)
                                     * (0.2 if s[0] == 1 else math.prod(s[:-1]) ** -0.5)
                                     for s in tf._SHAPES["trunk_s45"]])
    x = torch.randn(3, 16, 16, 480, generator=g, device=card).relu_()
    want = collections.Counter(tf.conv_tile_width(c.cout, F32)
                               for c in tf.conv_plan("trunk_s45", 16))
    tf.KERNEL.reset()
    with torch.no_grad():
        got = tf.trunk_s45(x, p)
        torch.cuda.synchronize()
        assert tf.conv_launches(F32) == dict(want)
        assert tf.conv_launches() == {}
        assert tf.launches("trunk_s45") == 1
        assert _rel(got, tf.trunk_s45_ref(x, p)) <= TRUNK_TOL
    tf.KERNEL.reset()
    assert tf.conv_launches(F32) == {}
