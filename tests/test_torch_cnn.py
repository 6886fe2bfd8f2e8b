"""The port's exact dense CNN (``srcfinder_torch.detect.cnn_pipeline``,
``cnn_cli``) and its trunk segments (``srcfinder_torch.ops.trunk_fuse``)
held against the JAX package on the CPU.

Both packages get the same Flax variables: a tree in the Flax layout made
with numpy (structure from the port's model, values from a seeded numpy
generator), rescaled to conv std sqrt(1 / fan_in) with BatchNorm perturbed
as after training, so activations stay O(1) through the trunk and the
saliency is far from constant. The port reads them through
``flax_to_torch_state_dict``. Tolerance: atol 1e-5 in f32, where the two
sides differ only in convolution algorithm and summation order (~1e-6 at
these activations). On the CPU the port's trunk kernels run their plain
versions.
"""

import copy
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from srcfinder_tpu.detect import cnn_pipeline as jcp
from srcfinder_tpu.models import googlenet as jgooglenet
from srcfinder_tpu.models.googlenet import _ceil_maxpool as jpool
from srcfinder_tpu.models.googlenet import fold_inference as jfold
from srcfinder_torch.core.envi import open_envi, save_envi
from srcfinder_torch.detect import cnn_cli
from srcfinder_torch.detect import cnn_pipeline as tcp
from srcfinder_torch.models import convert
from srcfinder_torch.models.googlenet import (GoogLeNet, _ceil_maxpool, fold_inference,
                                              fold_state_dict, fuse_state_dict)
from srcfinder_torch.ops import trunk_fuse as tf

torch.set_num_threads(1)

ATOL = 1e-5
DIM = 32                       # window side of the CPU tests
IMG = (9, 13)                  # 117 windows: 7 full batches of 16 and a padded tail
BATCH = 16


def _flax_model():
    return jgooglenet(num_classes=2, dropout=0.0, dropout_aux=0.0)


@pytest.fixture(scope="module")
def variables():
    """Trained-like Flax variables (numpy leaves)."""
    rng = np.random.default_rng(2801)
    tree = convert.torch_state_dict_to_flax(GoogLeNet(num_classes=2).state_dict())
    v = copy.deepcopy(tree)

    def walk(p, s):
        for k, a in p.items():
            if k == "bn":
                c = a["scale"].shape
                a["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                a["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(a, dict):
                walk(a, s.get(k, {}))
            elif k == "kernel":
                fan_in = np.prod(a.shape[:-1])
                p[k] = (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)
    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def folded(variables):
    """(Flax folded model, its variables, the port's folded model)."""
    fmodel, fvars = jfold(_flax_model(), variables)
    return fmodel, fvars, fold_inference(_port_model(variables))


def _port_model(variables):
    model = GoogLeNet(num_classes=2)
    model.load_state_dict(convert.flax_to_torch_state_dict(variables))
    return model.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_stages(folded):
    """Windows and the JAX model's stage compositions for them: the
    references of fused_stage12, s23 (its input: conv1's output) and s45
    (its input: the s23 reference)."""
    fmodel, fvars, _ = folded
    wins = np.random.default_rng(3).normal(0.0, 1.0, (2, DIM, DIM, 1)).astype(np.float32)

    def stage(x, k, **kw):
        return fmodel.apply(fvars, x, train=False, stage=k, **kw)
    c1 = stage(jnp.asarray(wins), 1)
    c3 = stage(c1, 2)
    ref23 = jpool(stage(c3, 3), 3, 2)
    s4 = stage(ref23, 4, start_stage=4, start_pooled=True)
    ref45 = stage(s4, 5, start_stage=5).mean(axis=(1, 2))
    return {"wins": wins, "c1": np.asarray(c1), "ref12": np.asarray(jpool(c3, 3, 2)),
            "ref23": np.asarray(ref23), "ref45": np.asarray(ref45)}


def test_midtrunk_resume_matches_full_and_jax(folded, jax_stages):
    """start_stage / start_pooled rebuild the full forward from pieces, in
    the port and against the JAX package."""
    fmodel, fvars, tmodel = folded
    wins = jax_stages["wins"]
    x = _nchw(wins)
    ref = np.asarray(fmodel.apply(fvars, jnp.asarray(wins), train=False))
    with torch.no_grad():
        full = tmodel(x)
        s2 = tmodel(tmodel(x, stage=1), stage=2)
        p3 = tmodel(_ceil_maxpool(s2, 3, 2), start_stage=3, start_pooled=True)
        s3 = tmodel(s2, stage=3)
        p4 = _ceil_maxpool(s3, 3, 2)
        from4 = tmodel(p4, start_stage=4, start_pooled=True)
        from5 = tmodel(tmodel(p4, stage=4, start_stage=4, start_pooled=True), start_stage=5)
        jfrom4 = fmodel.apply(fvars, jnp.asarray(jax_stages["ref23"]), train=False,
                              start_stage=4, start_pooled=True)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(full.numpy(), ref, rtol=0, atol=ATOL)
    for got in (p3, from4, from5):
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p4.permute(0, 2, 3, 1).numpy(), jax_stages["ref23"],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(from4.numpy(), np.asarray(jfrom4), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", ["canonical", "fused0"])
def test_plain_trunk_segments_match_jax_stages(variables, jax_stages, layout):
    """fused_stage12, s23 and s45 (their plain versions on the CPU) with
    parameters from the canonical and the fused0 layout == the JAX model's
    stage compositions."""
    sd = {k: v.numpy() for k, v in convert.flax_to_torch_state_dict(variables).items()}
    sd = fold_state_dict(fuse_state_dict(sd) if layout == "fused0" else sd)
    assert ("inception3a.fused0.conv.weight" in sd) == (layout == "fused0")
    wins, c1, ref23 = (torch.tensor(jax_stages[k]) for k in ("wins", "c1", "ref23"))
    got = {"ref12": tf.fused_stage12(wins, tf.stage12_params(sd)),
           "ref23": tf.trunk_s23(c1, tf.trunk_segment_params(sd, "s23")),
           "ref45": tf.trunk_s45(ref23, tf.trunk_segment_params(sd, "s45"))}
    for k, g in got.items():
        ref = jax_stages[k]
        assert g.shape == ref.shape and np.abs(ref).max() > 0.1, k
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=ATOL, err_msg=k)


def test_plain_trunk_segments_bf16_close_to_f32(folded, jax_stages):
    """The bf16 plain versions (bf16 inputs and weights, f32 accumulation,
    bf16 rounding after each conv) stay within 2% of the largest f32
    output, the ceiling the CUDA kernels are held to in bf16; measured
    0.3-0.6% here."""
    sd = folded[2].state_dict()
    cases = [(tf.fused_stage12, tf.stage12_params(sd), "wins", "ref12"),
             (tf.trunk_s23, tf.trunk_segment_params(sd, "s23"), "c1", "ref23"),
             (tf.trunk_s45, tf.trunk_segment_params(sd, "s45"), "ref23", "ref45")]
    for fn, params, src, ref in cases:
        x = torch.tensor(jax_stages[src]).to(torch.bfloat16)
        got = fn(x, [p.to(torch.bfloat16) for p in params])
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - jax_stages[ref]).max()
        assert err <= 2e-2 * np.abs(jax_stages[ref]).max(), (ref, err)


def _sd(variables, layout):
    """The port's folded state_dict in the canonical or the fused0 layout."""
    sd = {k: v.numpy() for k, v in convert.flax_to_torch_state_dict(variables).items()}
    sd = fold_state_dict(fuse_state_dict(sd) if layout == "fused0" else sd)
    assert ("inception3a.fused0.conv.weight" in sd) == (layout == "fused0")
    return sd


@pytest.mark.parametrize("layout", ["canonical", "fused0"])
def test_stage12_route_matches_jax_stages(variables, jax_stages, layout):
    """The stage12 route's two entry points: fused_stage12_gather of the
    windows laid into a scene of non-zero pixels == fused_stage12 of the
    windows bit for bit and the JAX package's stage 1+2 + pool within
    1e-5; trunk_s3 of that == its stage 3 + pool; the "s3" params are the
    s23 list without conv2 and conv3."""
    sd = _sd(variables, layout)
    wins = jax_stages["wins"]
    scene = np.random.default_rng(9).normal(1.0, 1.0, (DIM + 10, 2 * DIM + 17)).astype(np.float32)
    origins = [(3, 4), (7, DIM + 12)]
    for (r, c), w in zip(origins, wins):
        scene[r:r + DIM, c:c + DIM] = w[..., 0]
    p12, p3 = tf.stage12_params(sd), tf.trunk_segment_params(sd, "s3")
    got = tf.fused_stage12_gather(torch.from_numpy(scene), torch.tensor(origins), DIM, p12)
    torch.testing.assert_close(got, tf.fused_stage12(torch.from_numpy(wins), p12), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), jax_stages["ref12"], rtol=0, atol=ATOL)
    s3 = tf.trunk_s3(got, p3)
    assert s3.shape == jax_stages["ref23"].shape
    np.testing.assert_allclose(s3.numpy(), jax_stages["ref23"], rtol=0, atol=ATOL)
    s23 = tf.trunk_segment_params(sd, "s23")
    assert len(p3) == len(s23) - 4 and all(torch.equal(a, b) for a, b in zip(p3, s23[4:]))
    torch.testing.assert_close(tf.trunk_s3(got, tf.pack_params("trunk_s3", p3)), s3,
                               rtol=0, atol=0)


def test_stage12_gather_window_edges(folded):
    """Windows flush with each corner of a scene of non-zero pixels, one
    inside it and two reaching past its edges: each == fused_stage12 of
    the window cut from the zero-extended scene, bit for bit. So conv1's
    pad 3 reads the window's own zeros, never the scene pixels beside the
    window, and pixels past the scene read 0."""
    params = tf.stage12_params(folded[2].state_dict())
    h, w = DIM + 9, DIM + 14
    scene = np.random.default_rng(12).normal(1.0, 1.0, (h, w)).astype(np.float32)
    assert (scene != 0).all()
    origins = [(0, 0), (0, w - DIM), (h - DIM, 0), (h - DIM, w - DIM), (4, 5), (-3, 2),
               (h - DIM + 5, w - DIM + 2)]
    ext = np.pad(scene, DIM)
    crops = np.stack([ext[r + DIM:r + 2 * DIM, c + DIM:c + 2 * DIM] for r, c in origins])
    got = tf.fused_stage12_gather(torch.from_numpy(scene), torch.tensor(origins), DIM, params)
    ref = tf.fused_stage12(torch.from_numpy(crops[..., None]), params)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # a halo read from the scene would differ: conv1 of the window at (4,
    # 5) padded by its scene neighbours, not by zeros
    k1, b1 = params[0].reshape(7, 7, 1, 64), params[1]
    zero_pad = tf._conv_ref(torch.from_numpy(crops[4][None, None]), k1, b1, 2, 3)
    scene_pad = tf._conv_ref(torch.from_numpy(scene[None, None, 1:DIM + 7, 2:DIM + 8]), k1, b1, 2)
    assert zero_pad.shape == scene_pad.shape
    assert (zero_pad - scene_pad).abs().max() > 0.1


def test_stage12_route_bf16_close_to_f32(folded, jax_stages):
    """fused_stage12_gather and trunk_s3 in bf16 (their plain versions)
    stay within 2% of the largest f32 output of the JAX package's stages,
    the ceiling the CUDA kernels are held to in bf16."""
    sd = folded[2].state_dict()
    plane = torch.from_numpy(np.concatenate(list(jax_stages["wins"][..., 0]), axis=1))
    origins = torch.tensor([[0, 0], [0, DIM]])
    bf = torch.bfloat16
    got = tf.fused_stage12_gather(plane.to(bf), origins, DIM,
                                  [p.to(bf) for p in tf.stage12_params(sd)])
    s3 = tf.trunk_s3(torch.tensor(jax_stages["ref12"]).to(bf),
                     [p.to(bf) for p in tf.trunk_segment_params(sd, "s3")])
    for g, ref in ((got, "ref12"), (s3, "ref23")):
        assert g.dtype == bf
        err = np.abs(g.float().numpy() - jax_stages[ref]).max()
        assert err <= 2e-2 * np.abs(jax_stages[ref]).max(), (ref, err)


def test_stage12_checks_origins_and_devices():
    """The gather form takes (B, 2) int64 origins on the plane's device and
    D % 8 == 0, and refuses devices other than the CPU and CUDA."""
    plane = torch.zeros(40, 40)
    with pytest.raises(TypeError, match="int64"):
        tf.fused_stage12_gather(plane, torch.zeros(2, 2, dtype=torch.int32), 32, [])
    with pytest.raises(TypeError, match="int64"):
        tf.fused_stage12_gather(plane, torch.zeros(2, 3, dtype=torch.int64), 32, [])
    with pytest.raises(ValueError, match="D % 8"):
        tf.fused_stage12_gather(plane, torch.zeros(2, 2, dtype=torch.int64), 30, [])
    with pytest.raises(ValueError, match="origins on"):
        tf.fused_stage12_gather(plane, torch.zeros(2, 2, dtype=torch.int64, device="meta"), 32, [])
    with pytest.raises(ValueError, match="2-D plane"):
        tf.fused_stage12_gather(plane[:, ::2], torch.zeros(2, 2, dtype=torch.int64), 16, [])
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_stage12_gather(torch.zeros(40, 40, device="meta"),
                                torch.zeros(2, 2, dtype=torch.int64, device="meta"), 32, [])
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_stage12(torch.zeros(2, 32, 32, 1, device="meta"), [])
    with pytest.raises(ValueError, match="unsupported device"):
        tf.trunk_s3(torch.zeros(2, 4, 4, 192, device="meta"), [])


def test_packed_weights_are_the_fused_layout(folded):
    """The weight packing both versions read: each inception's wide 1x1 is
    the fused0 conv in (cin, cout) layout; shapes are checked, and weights
    packed once give what the flat list gives."""
    sd = folded[2].state_dict()
    params = tf.trunk_segment_params(sd, "s45")
    packed = tf.pack_params("trunk_s45", params, dtype=torch.bfloat16)
    assert len(packed.tensors) == 8 * 7
    assert all(t.dtype == torch.bfloat16 for t in packed.tensors)
    packed = tf.pack_params("trunk_s45", params)
    w = sd["inception4a.fused0.conv.weight"][:, :, 0, 0].t()
    torch.testing.assert_close(packed.tensors[0], w, rtol=0, atol=0)
    torch.testing.assert_close(packed.tensors[1][0], sd["inception4a.fused0.conv.bias"],
                               rtol=0, atol=0)
    x = torch.randn(2, 2, 2, 480, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(tf.trunk_s45(x, packed), tf.trunk_s45(x, params),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="weight shapes"):
        tf.pack_params("trunk_s23", params)
    with pytest.raises(ValueError, match="packed for trunk_s45"):
        tf.trunk_s23(torch.zeros(1, 32, 32, 64), packed)
    with pytest.raises(ValueError, match="BN-folded"):
        tf.stage12_params(GoogLeNet(num_classes=2).state_dict())


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 32, 32, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tf.trunk_s23(x, [])
    with pytest.raises(ValueError, match="unsupported device"):
        tf.conv(x, torch.empty(64, 8, device="meta"), torch.empty(1, 8, device="meta"),
                torch.empty(1, 32, 32, 8, device="meta"))


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("name,side,dtype,batch,parts", [
    ("trunk_s23", 128, BF16, 4096, 3),       # the CLI: bf16, batch 4096, D = 256
    ("trunk_s45", 16, BF16, 4096, 1),
    ("trunk_s23", 128, F32, 4096, 5),
    ("trunk_s23", 128, F32, 512, 1),
    ("fused_stage12", 256, F32, 512, 1),
    ("fused_stage12", 256, BF16, 4096, 1),   # 2 MiB a window: exactly the budget
    ("trunk_s3", 32, BF16, 4096, 2)])
def test_scratch_plan_sub_batches(name, side, dtype, batch, parts):
    """The sub-batches a segment runs in: as many windows as keep the
    scratch plan within SCRATCH_BUDGET_BYTES."""
    sub = tf.sub_batch(name, batch, side, dtype)
    assert math.ceil(batch / sub) == parts
    window = sum(math.prod(s) for s in tf.scratch_plan(name, side)) * (2 if dtype == BF16 else 4)
    assert sub * window <= tf.SCRATCH_BUDGET_BYTES < (sub + 1) * window or sub == batch


@pytest.mark.parametrize("side", [16, 128])
def test_scratch_plan_holds_branch4_pooled_maps(side):
    """trunk_s23 keeps branch 4's pooled block input in conv2's dead map,
    which is exactly (h/4)^2 * 256 elements: 3b's input, the larger of
    the two; trunk_s45 has a map of its own as wide as its widest input."""
    s23 = tf.scratch_plan("trunk_s23", side)
    h4 = side // 4
    widest = max(tf._cin(b) for b in tf._BLOCKS["s23"])
    assert math.prod(s23[1]) == h4 * h4 * 256 == h4 * h4 * widest
    g = side // 8
    s45 = tf.scratch_plan("trunk_s45", g)
    assert s45[3] == (g, g, max(tf._cin(b) for b in tf._BLOCKS["s45"])) == (g, g, 832)


@pytest.mark.parametrize("name,side,convs", [("trunk_s23", 128, 10), ("trunk_s45", 16, 28),
                                             ("trunk_s3", 32, 8)])
def test_conv_plan_meets_tensor_core_rule(name, side, convs):
    """Every conv of P3 meets the tensor-core kernels' alignment rule in
    bf16 and in f32 (3xTF32); P2 launches only conv3 through the dispatch
    (its conv1 and conv2 run inside its front kernel), and conv3 meets it
    in both dtypes."""
    plan = tf.conv_plan(name, side)
    assert len(plan) == convs and len({c.layer for c in plan}) == convs
    assert all(tf.tensor_core_ok(c) for c in plan)
    assert all(tf.tensor_core_ok(c, F32) for c in plan)
    p2 = tf.conv_plan("fused_stage12", 256)
    assert [(c.layer, c.side, tf.tensor_core_ok(c), tf.tensor_core_ok(c, F32))
            for c in p2] == [("conv3", 64, True, True)]


#: the plans of the segments at the CLI's window side (256), and of trunk_s23
PLANS = [("fused_stage12", 256), ("trunk_s23", 128), ("trunk_s3", 32), ("trunk_s45", 16)]
PLAN_CONVS = [(name, c) for name, side in PLANS for c in tf.conv_plan(name, side)]


#: each conv of the plans in each dtype (the bf16 cases keep their first ids)
PLAN_TILE_CASES = ([pytest.param(BF16, n, c, id=f"{n}-{c.layer}") for n, c in PLAN_CONVS]
                   + [pytest.param(F32, n, c, id=f"f32-{n}-{c.layer}") for n, c in PLAN_CONVS])


@pytest.mark.parametrize("dtype,name,c", PLAN_TILE_CASES)
def test_conv_tile_width_on_plan(dtype, name, c):
    """The rule (conv_tile_width, tc_tile of csrc/trunk.cu) gives each conv
    of the plans the fewest column tiles of at most 256 channels in bf16
    (conv_wgmma_kernel), 128 in f32 (conv_tf32x3_kernel, whose consumers
    hold the sum and the slice's partial), one wherever cout is at most
    that, at a width that is a multiple of the dtype's granule (32 in bf16,
    half a B box; 16 in f32) and covers its share of cout."""
    most, granule = {BF16: (256, 32), F32: (128, 16)}[dtype]
    assert (tf.TILE_MAX[dtype], tf.TILE_GRANULE[dtype]) == (most, granule)
    w = tf.conv_tile_width(c.cout, dtype)
    tiles = -(-c.cout // w)
    assert 0 < w <= most and w % granule == 0 and w in tf.TILE_WIDTHS[dtype]
    assert tiles == -(-c.cout // most) and (tiles == 1) == (c.cout <= most)
    assert w - granule < -(-c.cout // tiles) <= w


@pytest.mark.parametrize("name,side", PLANS)
def test_conv_tile_width_pads_less_than_64_128(name, side):
    """Summed over a plan, the tiles of both dtypes compute no more padded
    MACs than the 64/128 rule's (the one of 64 and 128 that pads cout
    less, 128 on a tie)."""
    def padded(width):
        return sum(c.side ** 2 * c.k ** 2 * c.cin * -(-c.cout // width(c.cout)) * width(c.cout)
                   for c in tf.conv_plan(name, side))
    real = padded(lambda cout: cout)
    old = padded(lambda cout: 128 if cout % 128 == 0 or cout % 128 > 64 else 64)
    for dtype in (BF16, F32):
        assert real <= padded(lambda cout: tf.conv_tile_width(cout, dtype)) <= old


@pytest.mark.parametrize("name,side", PLANS)
def test_split_scratch_holds_each_conv(name, side):
    """split_scratch gives an entry point room for hi and lo of each of its
    f32 convs' weights, and no more than those of its largest: 5.3 MB at
    most (trunk_s45's inception5b.branch2, 3 x 3 x 192 x 384)."""
    sizes = [c.k * c.k * c.cin * c.cout for c in tf.conv_plan(name, side)]
    assert tf.split_scratch(name, side) == 2 * max(sizes)
    assert tf.split_scratch(name, side) * 4 <= 2 * 3 * 3 * 192 * 384 * 4 < 5.4e6


@pytest.mark.parametrize("dtype,cin,x_off,shift,cout,ok", [
    (F32, 8, 0, 0, 16, True),      # the rule met (one 16-wide tile)
    (F32, 8, 0, 0, 208, True),     # met (208: two tiles of 112)
    (F32, 6, 0, 0, 16, False),     # 6 channels: a vector of 4 would cross a tap
    (F32, 8, 2, 0, 16, False),     # channel offset 2: the vectors lie off 16 bytes
    (F32, 8, 0, 1, 16, False),     # the map 4 bytes off 16-byte alignment
    (BF16, 8, 4, 0, 16, False)])   # bf16 vectors hold 8 channels: offset 4 is refused
def test_tensor_core_rule_on_maps(dtype, cin, x_off, shift, cout, ok):
    """The dispatch rule on maps laid out as the segments lay them, the
    map's pointer offset from 16 bytes counted as a channel offset:
    tensor_core_ok refuses in f32 a channel count, an offset or a pointer
    that would put a 16-byte vector of 4 channels across a tap or off its
    alignment. The conv itself runs on the CPU whatever the rule says."""
    g = torch.Generator().manual_seed(5)
    flat = torch.randn(shift + 2 * 3 * 3 * 16, generator=g).to(dtype)
    X = flat[shift:].view(2, 3, 3, 16)
    x = X[..., x_off:x_off + cin]
    k, b = torch.randn(cin, cout, generator=g).to(dtype), torch.randn(1, cout, generator=g).to(dtype)
    y = torch.full((2, 3, 3, cout), float("nan"), dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    off = x.data_ptr() % 16 // x.element_size()
    c = tf.ConvLaunch("probe", 3, cin, 16, off, cout, 1, 1, 0, cout, 0, cout, cout)
    assert tf.tensor_core_ok(c, dtype) == ok
    tf.conv(x, k, b, y)
    torch.testing.assert_close(y, tf._nhwc(tf._conv_ref(tf._nchw(x), k, b)), rtol=0, atol=0)


def _replay(name, x, ws):
    """fused_stage12 / trunk_s23 / trunk_s3 / trunk_s45 on the CPU as
    csrc/trunk.cu sequences them: each conv of conv_plan through tf.conv
    on channel slices of maps laid out at the start of scratch_plan's
    NaN-filled buffers, the pools between them, branch 4's pooled input
    where the kernel keeps it; fused_stage12's front kernel (conv1, pool,
    conv2) writes its first map."""
    n, side = x.shape[0], x.shape[1]
    s = [torch.full((n,) + sh, float("nan"), dtype=x.dtype) for sh in tf.scratch_plan(name, side)]
    todo = list(zip(tf.conv_plan(name, side), ws[::2], ws[1::2]))

    def at(buf, h, ch):
        return buf.view(-1)[:n * h * h * ch].view(n, h, h, ch)

    def conv(src, dst, red=None):
        c, k, b = todo.pop(0)
        tf.conv(src[..., c.x_off:c.x_off + c.cin], k, b, dst[..., c.y_off:c.y_off + c.split],
                None if red is None else red[..., :c.cout - c.split], c.stride, c.pad)

    def pool(src, dst, k, st):
        t = tf._nchw(src)
        dst.copy_((_ceil_maxpool(t, k, st) if st > 1 else F.max_pool2d(t, k, 1, 1))
                  .permute(0, 2, 3, 1))
        return dst

    def inception(xin, red_buf, pooled_buf, out_buf):
        wide, h = todo[0][0], xin.shape[1]
        red, out = at(red_buf, h, wide.ldy1), at(out_buf, h, wide.ldy0)
        conv(xin, out, red)
        conv(red, out)
        conv(red, out)
        conv(pool(xin, at(pooled_buf, h, xin.shape[3]), 3, 1), out)
        return out

    if name == "fused_stage12":
        s[0].copy_(tf._front_ref(x, ws).permute(0, 2, 3, 1))
        todo = list(zip(tf.conv_plan(name, side), ws[4::2], ws[5::2]))
        conv(s[0], s[1])
        out = _ceil_maxpool(tf._nchw(s[1]), 3, 2).permute(0, 2, 3, 1)
    elif name in ("trunk_s23", "trunk_s3"):
        if name == "trunk_s23":
            conv(pool(x, s[0], 3, 2), s[1])
            conv(s[1], s[2])
            x = pool(s[2], s[3], 3, 2)
            s = [s[4], s[1], s[5], s[6]]    # trunk_s3's scratch, as trunk_s23 passes it
        a = inception(x, s[0], s[1], s[2])
        y = inception(a, s[0], s[1], s[3])
        out = _ceil_maxpool(tf._nchw(y), 3, 2).permute(0, 2, 3, 1)
    else:
        y = x
        for i in range(5):
            y = inception(y, s[0], s[3], s[1 + i % 2])
        y = pool(y, at(s[2], side // 2, y.shape[3]), 2, 2)
        y = inception(inception(y, s[0], s[3], s[1]), s[0], s[3], s[2])
        out = y.float().mean(dim=(1, 2)).to(y.dtype)
    assert not todo
    return out


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("segment", ["s23", "s45", "s3", "stage12"])
def test_conv_plan_replays_segments(folded, jax_stages, segment, dtype):
    """conv_plan and scratch_plan, replayed in the kernel's order with its
    buffer reuse, give the plain version bit for bit and, in f32, the JAX
    package's stages within 1e-5; so the offsets, strides and splits that
    csrc/trunk.cu launches (and chip_smoke.py times one by one) compute
    the segment."""
    sd = folded[2].state_dict()
    name = "fused_stage12" if segment == "stage12" else f"trunk_{segment}"
    src, ref = {"s23": ("c1", "ref23"), "s45": ("ref23", "ref45"), "s3": ("ref12", "ref23"),
                "stage12": ("wins", "ref12")}[segment]
    x = torch.tensor(jax_stages[src]).to(dtype)
    params = (tf.stage12_params(sd) if segment == "stage12"
              else tf.trunk_segment_params(sd, segment))
    packed = tf.pack_params(name, params, dtype=dtype)
    got = _replay(name, x, packed.tensors)
    torch.testing.assert_close(got, getattr(tf, name)(x, packed), rtol=0, atol=0)
    if dtype == F32:
        np.testing.assert_allclose(got.numpy(), jax_stages[ref], rtol=0, atol=ATOL)


def test_conv_writes_only_its_channels():
    """tf.conv on channel slices: the split lands in y0 and y1 as one conv
    computes it, every other channel keeps its fill; mismatched shapes
    raise."""
    g = torch.Generator().manual_seed(11)
    X = torch.randn(2, 5, 5, 40, generator=g)
    k, b = torch.randn(3, 3, 24, 16, generator=g), torch.randn(1, 16, generator=g)
    Y, R = torch.full((2, 5, 5, 32), float("nan")), torch.full((2, 5, 5, 16), float("nan"))
    tf.conv(X[..., 8:32], k, b, Y[..., 8:16], R[..., :8], pad=1)
    ref = tf._conv_ref(tf._nchw(X[..., 8:32]), k, b, pad=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(torch.cat([Y[..., 8:16], R[..., :8]], 3), ref, rtol=0, atol=0)
    assert torch.isnan(Y[..., :8]).all() and torch.isnan(Y[..., 16:]).all()
    assert torch.isnan(R[..., 8:]).all()
    with pytest.raises(ValueError, match="do not fit"):
        tf.conv(X[..., 8:32], k, b, Y[..., 8:16])


def test_reference_pad_matches_jax():
    img = np.random.default_rng(4).normal(size=(5, 7)).astype(np.float32)
    for dim in (32, 256):
        np.testing.assert_array_equal(tcp.reference_pad(torch.from_numpy(img), dim).numpy(),
                                      np.asarray(jcp.reference_pad(img, dim)))


@pytest.fixture(scope="module")
def jax_saliency(variables):
    """A raw CH4 band with nodata pixels and the JAX package's
    cnn_saliency_image of it (f32, fused, dim 32, batch 16); the one XLA
    compile of the window scan at this shape serves every test here."""
    rng = np.random.default_rng(16)
    band = rng.normal(300.0, 400.0, IMG).astype(np.float32)
    band[0, :4] = -9999.0
    ref = np.asarray(jcp.cnn_saliency_image(band, variables, dim=DIM, batch=BATCH,
                                            model=_flax_model()))
    return band, ref


def test_cnn_window_saliency_matches_jax(folded):
    """All three trunk routes, batch 16 with a padded tail, == JAX's exact
    window scan; on the CPU the routes agree bit for bit."""
    fmodel, fvars, tmodel = folded
    img = np.random.default_rng(5).normal(0.0, 3.0, IMG).astype(np.float32)
    ref = np.asarray(jcp.cnn_window_saliency(fmodel, fvars, jnp.asarray(img),
                                             dim=DIM, batch=BATCH))
    assert ref.std() > 1e-3
    seen = []
    got = {t: tcp.cnn_window_saliency(tmodel, torch.from_numpy(img), dim=DIM,
                                      batch=BATCH, trunk=t,
                                      progress=lambda d, n: seen.append((d, n)))
           for t in tcp.TRUNKS}
    assert seen[-1] == (117, 117) and len(seen) == 3 * 8
    np.testing.assert_allclose(got["plain"].numpy(), ref, rtol=0, atol=ATOL)
    for t in ("segments", "stage12"):
        torch.testing.assert_close(got[t], got["plain"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown trunk"):
        tcp.cnn_window_saliency(tmodel, torch.from_numpy(img), dim=DIM, trunk="xla")


def test_cnn_fast_saliency_matches_jax(folded):
    fmodel, fvars, tmodel = folded
    img = np.random.default_rng(6).normal(0.0, 1.0, (6, 9)).astype(np.float32)
    ref = np.asarray(jcp.cnn_fast_saliency(fmodel, fvars, jnp.asarray(img), dim=64))
    got = tcp.cnn_fast_saliency(tmodel, torch.from_numpy(img), dim=64)
    assert got.shape == (6, 9) and ref.std() > 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_cnn_saliency_image_matches_jax(variables, jax_saliency):
    """Raw band -> saliency from the canonical model (folded inside),
    nodata re-stamped in f32, against JAX; the bf16 trunk stays within
    2e-2 of it."""
    band, ref = jax_saliency
    model = _port_model(variables)
    got = tcp.cnn_saliency_image(band, model, dim=DIM, batch=BATCH, device="cpu")
    assert got.dtype == torch.float32
    nodata = band == -9999.0
    np.testing.assert_array_equal(got.numpy() == -9999.0, nodata)
    assert ref[~nodata].std() > 1e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    bf16 = tcp.cnn_saliency_image(band, model, dim=DIM, batch=BATCH,
                                  dtype=torch.bfloat16, device="cpu").numpy()
    np.testing.assert_array_equal(bf16[nodata], -9999.0)
    assert np.abs(bf16 - ref).max() <= 2e-2
    with pytest.raises(ValueError, match="unknown method"):
        tcp.cnn_saliency_image(band, model, dim=DIM, method="dense", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcp.cnn_saliency_image(band, model, dim=DIM)


def test_cnn_cli_matches_jax(tmp_path, variables, jax_saliency):
    """cnn_cli.main on a one-band ENVI file, weights as .npz in the Flax
    layout: the saliency it writes == the JAX package's
    cnn_saliency_image of the same band, nodata stamped, map info kept."""
    band, ref = jax_saliency
    mapinfo = ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1", "11",
               "North", "WGS-84", "units=Meters", "rotation=0"]
    save_envi(str(tmp_path / "ang_ch4.hdr"), band[:, :, None],
              metadata={"data ignore value": -9999, "map info": mapinfo})
    wf = str(tmp_path / "w.npz")
    cnn_cli.save_weights(wf, variables)
    out = tmp_path / "out"
    rc = cnn_cli.main([str(tmp_path / "ang_ch4"), "-w", wf, "-n", "1", "--dim", str(DIM),
                       "-b", str(BATCH), "--dtype", "float32", "--superbatch", "1",
                       "--device", "cpu", "-o", str(out)])
    assert rc == 0
    img = open_envi(str(out / "ang_ch4_saliency"))
    got = img.load()[..., 0]
    assert img.metadata["map info"] == mapinfo
    np.testing.assert_array_equal(got == -9999.0, band == -9999.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert cnn_cli.main([str(tmp_path / "ang_ch4"), "-w", str(tmp_path / "none.npz"),
                         "--device", "cpu", "-o", str(out)]) == 1


def test_cnn_cli_imports_no_jax():
    code = ("import sys, srcfinder_torch.detect.cnn_cli, srcfinder_torch.detect.cnn_pipeline, "
            "srcfinder_torch.ops.trunk_fuse; "
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'srcfinder_tpu')]")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
