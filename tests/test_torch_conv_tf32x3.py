"""The arithmetic of the port's f32 convolution on the tensor cores
(``conv_tf32x3_kernel`` in ``srcfinder_torch/ops/csrc/trunk.cu``), held
on the CPU, where the kernel cannot run.

The kernel rounds each f32 operand v to hi = tf32(v) and lo = tf32(v - hi)
(``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away from zero,
the 13 bits below cleared; the weights once a conv, by
``conv_tf32x3_kernel_split``, whose plain version is ``trunk_fuse.split_tf32``,
the im2col rows of A in each consumer's registers) and accumulates lo_a
hi_b, hi_a lo_b and hi_a hi_b: 3xTF32. Each wgmma of depth 8 adds its products to its accumulator
rounding toward zero; each 32-deep slice of the reduction (4 k8 steps, 12
wgmma) sums into a partial of its own, and the partials are added into
the f32 sum rounding to nearest. Here numpy emulates that on the f32 bit
patterns, each wgmma's products summed exactly (two tf32 values multiply
exactly in f64) and added to the accumulator toward zero in f32:

- on every distinct f32 conv of ``trunk_fuse.conv_plan`` (P2's conv3,
  trunk_s23, trunk_s3, trunk_s45) at 1-2 windows of 256 x 256, within
  1e-6 of the largest output from the conv in f64;
- single-pass TF32 (one product of the rounded operands) misses 1e-5 on
  the same convs, so these tests tell the two designs apart;
- one accumulator over the whole reduction, rounding toward zero at every
  wgmma, misses 1e-5 on inception4e.branch2 (K = 1440), as it did on the
  card, where the partials hold;
- the segments replayed in the kernel's order with the emulated convs
  stay within 1e-5 of the JAX package's f32 stages;
- ``trunk_fuse.split_tf32`` splits the weights as this emulation does, each
  output channel's weights one K-major row.

The emulation lives here only; the port's CPU path runs the plain convs.
"""

import numpy as np
import pytest
import torch

from srcfinder_torch.ops import trunk_fuse as tf
from tests.test_torch_cnn import ATOL, _replay, folded, jax_stages, variables  # noqa: F401

F32 = torch.float32
WIN = 256                      # the window side the card runs
EXACT, TF32_MISS = 1e-6, 1e-5  # max |err| / max |f64 conv|
SLICE = 32                     # reduction depth of one slice: 4 wgmma k8 steps


def tf32(a):
    """``cvt.rna.tf32.f32`` of f32 values, the low 13 bits cleared."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def im2col(x, k, stride, pad):
    """(n, h, w, c) -> (n * ho * wo, k * k * c) rows, columns (ky, kx, c)
    as the kernel's reduction runs over the HWIO weight rows."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    taps = [xp[:, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    return np.concatenate(taps, axis=-1).reshape(n * ho * wo, k * k * c), (n, ho, wo)


def round_to_zero(s):
    """f64 values rounded to f32 toward zero."""
    r = s.astype(np.float32)
    over = np.abs(r) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def gemm_3xtf32(a, w, partials=True):
    """(M, K) @ (K, N) f32 as the kernel accumulates it: per k8 step the
    wgmma of lo_a hi_b, hi_a lo_b, hi_a hi_b (small terms first), each
    added to the accumulator toward zero; with ``partials`` a partial per
    32-deep slice, the partials summed in f32 to nearest, else (the first
    design) one accumulator over the whole reduction."""
    a_hi, w_hi = tf32(a), tf32(w)
    terms = [(p.astype(np.float64), q.astype(np.float64))
             for p, q in ((tf32(a - a_hi), w_hi), (a_hi, tf32(w - w_hi)), (a_hi, w_hi))]
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    part = acc
    for k0 in range(0, a.shape[1], SLICE):
        if partials:
            part = np.zeros_like(acc)
        for k in range(k0, min(k0 + SLICE, a.shape[1]), 8):
            for p, q in terms:
                part = round_to_zero(part + p[:, k:k + 8] @ q[k:k + 8])
        if partials:
            acc = acc + part
    return acc if partials else part


def conv_emulated(x, w, b, stride=1, pad=0, passes=3, partials=True):
    """Conv + bias + ReLU of NHWC ``x`` with a (cin, cout) or HWIO ``w`` as
    the kernel computes it (``passes`` 3) or as single-pass TF32 (1)."""
    k = 1 if w.ndim == 2 else w.shape[0]
    a, shape = im2col(np.asarray(x, np.float32), k, stride, pad)
    wm = np.asarray(w, np.float32).reshape(-1, w.shape[-1])
    acc = tf32(a) @ tf32(wm) if passes == 1 else gemm_3xtf32(a, wm, partials)
    out = np.maximum(acc + np.asarray(b, np.float32).reshape(1, -1), np.float32(0))
    return out.reshape(*shape, -1)


def conv_f64(x, w, b, stride=1, pad=0):
    k = 1 if w.ndim == 2 else w.shape[0]
    a, shape = im2col(np.asarray(x, np.float64), k, stride, pad)
    out = a @ np.asarray(w, np.float64).reshape(-1, w.shape[-1]) + np.asarray(b, np.float64)
    return np.maximum(out, 0).reshape(*shape, -1)


def _f32_convs():
    """The distinct f32 convs the segments launch through the dispatch,
    at the card's window side."""
    out, seen = [], set()
    for name, side in (("fused_stage12", WIN), ("trunk_s23", WIN // 2), ("trunk_s3", WIN // 8),
                       ("trunk_s45", WIN // 16)):
        for c in tf.conv_plan(name, side):
            key = (c.side, c.cin, c.cout, c.k, c.stride, c.pad)
            if key not in seen:
                seen.add(key)
                out.append(pytest.param(c, id=f"{name}-{c.layer}"))
    return out


def _seeded_conv(c):
    """Seeded input, weights and bias of conv ``c`` at 1-2 windows."""
    rng = np.random.default_rng(c.side * 1000 + c.cin + c.cout)
    n = 1 if c.side >= 64 else 2
    fan_in = c.k * c.k * c.cin
    x = np.maximum(rng.normal(size=(n, c.side, c.side, c.cin)), 0).astype(np.float32)
    w = (rng.normal(size=(c.k, c.k, c.cin, c.cout)) / np.sqrt(fan_in)).astype(np.float32)
    b = (0.2 * rng.normal(size=(1, c.cout))).astype(np.float32)
    return x, (w[0, 0] if c.k == 1 else w), b


@pytest.mark.parametrize("c", _f32_convs())
def test_3xtf32_is_f32_exact_and_tf32_is_not(c):
    """3xTF32 within 1e-6 of the f64 conv on every f32 conv shape of the
    segments (the f32 trunk's 1e-5 holds over up to 14 stacked convs);
    one TF32 product misses 1e-5 on each."""
    x, w, b = _seeded_conv(c)
    assert tf.tensor_core_ok(c, F32)
    ref = conv_f64(x, w, b, c.stride, c.pad)
    scale = np.abs(ref).max()
    err3 = np.abs(conv_emulated(x, w, b, c.stride, c.pad) - ref).max() / scale
    err1 = np.abs(conv_emulated(x, w, b, c.stride, c.pad, passes=1) - ref).max() / scale
    assert err3 <= EXACT, err3
    assert err1 > TF32_MISS, err1


def test_partials_beat_one_accumulator_rounding_to_zero():
    """On inception4e.branch2 (160 -> 320 channels, 3 x 3: K = 1440, 45
    slices) one accumulator rounding toward zero at each of its 540 wgmma
    drifts toward zero and misses 1e-5 (1.28e-5 here; 1.15e-5 from the
    plain conv on an H100); the partials per slice, summed to nearest, hold
    the error within 1e-6 of the f64 conv (3.9e-7 here)."""
    c = next(c for c in tf.conv_plan("trunk_s45", WIN // 16) if c.layer == "inception4e.branch2")
    x, w, b = _seeded_conv(c)
    ref = conv_f64(x, w, b, c.stride, c.pad)
    scale = np.abs(ref).max()
    sliced = np.abs(conv_emulated(x, w, b, c.stride, c.pad) - ref).max() / scale
    one = np.abs(conv_emulated(x, w, b, c.stride, c.pad, partials=False) - ref).max() / scale
    assert sliced <= EXACT, sliced
    assert one > TF32_MISS and one > 3 * sliced, (one, sliced)
    # the drift has one sign: toward zero, below the f64 conv where it is positive
    drift = conv_emulated(x, w, b, c.stride, c.pad, partials=False) - ref
    assert (drift[ref > 0.1 * scale] < 0).mean() > 0.9


def test_round_to_zero():
    """The emulated accumulation's rounding: f64 to f32 toward zero in both
    signs, exact values kept."""
    s = np.array([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30, 0.5, -3.0])
    np.testing.assert_array_equal(round_to_zero(s), np.array(
        [1.0, -1.0, np.nextafter(np.float32(1), np.float32(0)), 0.5, -3.0], np.float32))


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna: 10 mantissa bits kept, halfway cases away
    from zero in both signs, and hi + lo within 2^-22 of v."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    half = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11], np.float32)
    np.testing.assert_array_equal(tf32(half), np.array([one + ulp, -(one + ulp), one + 2 * ulp],
                                                       np.float32))
    v = np.random.default_rng(1).normal(size=4096).astype(np.float32)
    hi = tf32(v)
    lo = tf32(v - hi)
    assert ((hi.view(np.uint32) & 0x1FFF) == 0).all() and ((lo.view(np.uint32) & 0x1FFF) == 0).all()
    assert (np.abs(hi.astype(np.float64) + lo - v) <= 2.0 ** -22 * np.abs(v)).all()
    assert (np.abs(hi.astype(np.float64) - v) > 2.0 ** -22 * np.abs(v)).any()


@pytest.mark.parametrize("shape", [(480, 304), (3, 3, 16, 48), (3, 3, 192, 384)],
                         ids=["1x1", "3x3-narrow", "3x3-largest"])
def test_weight_split_is_k_major_hi_lo(shape):
    """trunk_fuse.split_tf32, the plain version of the kernel's weight
    split: hi and lo of each weight as this file's tf32 gives them, both
    with their low 13 bits clear, hi + lo within 2^-22 of the weight, laid
    out (cout, Kd) with output channel n's weights in row n in the
    reduction's (ky, kx, cin) order (K-major)."""
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * np.exp(rng.normal(size=shape) * 4)).astype(np.float32)
    hi, lo = (t.numpy() for t in tf.split_tf32(torch.from_numpy(w)))
    cout, kd = shape[-1], int(np.prod(shape[:-1]))
    assert hi.shape == lo.shape == (cout, kd) and hi.flags.c_contiguous
    wt = w.reshape(kd, cout).T
    np.testing.assert_array_equal(hi.view(np.uint32), tf32(wt).view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32), tf32(wt - tf32(wt)).view(np.uint32))
    assert ((hi.view(np.uint32) & 0x1FFF) == 0).all() and ((lo.view(np.uint32) & 0x1FFF) == 0).all()
    assert (np.abs(hi.astype(np.float64) + lo - wt) <= 2.0 ** -22 * np.abs(wt)).all()
    if len(shape) == 4:                     # weight (ky, kx, ci, n) at row n, column (ky, kx, ci)
        k, cin = shape[0], shape[2]
        for ky, kx, ci, n in ((0, 0, 0, 0), (2, 1, cin - 1, cout - 1), (1, 2, 3, 5)):
            assert hi[n, (ky * k + kx) * cin + ci] == tf32(w[ky, kx, ci, n])


def _conv_3xtf32(x, k, b, y0, y1=None, stride=1, pad=0):
    """tf.conv with the kernel's arithmetic emulated (CPU tensors)."""
    out = torch.from_numpy(conv_emulated(x.numpy(), k.numpy(), b.numpy(), stride, pad))
    y0.copy_(out[..., :y0.shape[3]])
    if y1 is not None:
        y1.copy_(out[..., y0.shape[3]:])
    return y0, y1


@pytest.mark.parametrize("segment", ["s23", "s3", "s45", "stage12"])
def test_segments_with_3xtf32_convs_match_jax(folded, jax_stages, segment, monkeypatch):
    """The segments replayed as csrc/trunk.cu sequences them, every conv
    of the dispatch in emulated 3xTF32 (P2's front kernel, which keeps its
    FMA convs, in its plain version), within 1e-5 of the JAX package's f32
    stages."""
    sd = folded[2].state_dict()
    name = "fused_stage12" if segment == "stage12" else f"trunk_{segment}"
    src, ref = {"s23": ("c1", "ref23"), "s45": ("ref23", "ref45"), "s3": ("ref12", "ref23"),
                "stage12": ("wins", "ref12")}[segment]
    params = (tf.stage12_params(sd) if segment == "stage12"
              else tf.trunk_segment_params(sd, segment))
    ws = tf.pack_params(name, params).tensors
    x = torch.tensor(jax_stages[src])
    plain = _replay(name, x, ws)
    monkeypatch.setattr(tf, "conv", _conv_3xtf32)
    got = _replay(name, x, ws)
    assert not torch.equal(got, plain)       # the emulated convs ran
    assert np.abs(jax_stages[ref]).max() > 0.1
    np.testing.assert_allclose(got.numpy(), jax_stages[ref], rtol=0, atol=ATOL)
