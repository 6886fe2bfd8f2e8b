"""GoogLeNet trunk segments of the exact dense CNN: CUDA kernels + plain versions.

Functions over a batch of windows, in the JAX package's NHWC layout,
with BN-folded weights (``models.googlenet.fold_state_dict``):

- :func:`fused_stage12`: (B, D, D, 1) windows -> conv1 -> ceil-pool ->
  conv2 -> conv3 -> ceil-pool -> (B, D/8, D/8, 192); D % 8 == 0.
  :func:`fused_stage12_gather` computes the same from a padded scene and
  each window's (row, col) origin, so the windows are never written out.
- :func:`trunk_s23`: (B, h, h, 64) conv1 outputs -> ceil-pool -> conv2 ->
  conv3 -> ceil-pool -> :func:`trunk_s3` -> (B, h/8, h/8, 480); h % 16 == 0.
- :func:`trunk_s3`: (B, g, g, 192), stage 2 after its pool ->
  inception3a/3b -> ceil-pool -> (B, g/2, g/2, 480); g even.
- :func:`trunk_s45`: (B, g, g, 480) -> inception4a..4e -> max-pool 2x2/2 ->
  inception5a/5b -> global average pool -> (B, 1024); g even.

For tensors on the CPU each runs its plain PyTorch version
(``*_ref``, built from ``F.conv2d``/``F.max_pool2d``); for CUDA tensors it
launches ``csrc/trunk.cu`` (built for ``sm_90a`` at first use) and raises
if it cannot. In bf16 the convolutions run on the tensor cores: every conv
of the segments and ``fused_stage12``'s conv3 through the dispatch of
:func:`tensor_core_ok` (:func:`conv_plan` lists them; :func:`conv` runs
one of them alone), its conv1 and conv2 inside its front kernel. The
kernels replace the JAX package's Pallas kernels
``ops/trunk_fuse.py::fused_stage12`` (git be3cd8d) and
``ops/trunk_fuse.py::fused_trunk_segment`` (git ca79403). Both versions
round where those did: f32 accumulation, bias and ReLU in f32, one rounding
to the input dtype after each conv; pools in the input dtype; the global
average pool a mean in f32.

Parameters come from :func:`stage12_params` and
:func:`trunk_segment_params` as flat lists in the Pallas kernels' layouts:
1x1 kernels (cin, cout), kxk kernels HWIO, biases (1, cout). Every
function takes such a list, or the same weights packed once for a device
and dtype by :func:`pack_params`, as a batch loop should pass them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models.googlenet import _ceil_maxpool
from .build import CudaKernel

__all__ = ["fused_stage12", "fused_stage12_gather", "trunk_s23", "trunk_s3", "trunk_s45", "conv",
           "conv_tile", "fused_stage12_ref", "trunk_s23_ref", "trunk_s3_ref", "trunk_s45_ref",
           "stage12_params",
           "trunk_segment_params", "pack_params", "PackedParams", "launches",
           "KERNEL", "SCRATCH_BUDGET_BYTES", "scratch_plan", "sub_batch",
           "conv_plan", "ConvLaunch", "tensor_core_ok"]

#: inception channel plans (reference: cnn/archs/googlenet1.py:64-79):
#: name -> (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj)
_INCEPTION = {
    "inception3a": (64, 96, 128, 16, 32, 32),
    "inception3b": (128, 128, 192, 32, 96, 64),
    "inception4a": (192, 96, 208, 16, 48, 64),
    "inception4b": (160, 112, 224, 24, 64, 64),
    "inception4c": (128, 128, 256, 24, 64, 64),
    "inception4d": (112, 144, 288, 32, 64, 64),
    "inception4e": (256, 160, 320, 32, 128, 128),
    "inception5a": (256, 160, 320, 32, 128, 128),
    "inception5b": (384, 192, 384, 48, 128, 128),
}
_BLOCKS = {"s23": ("inception3a", "inception3b"), "s3": ("inception3a", "inception3b"),
           "s45": ("inception4a", "inception4b", "inception4c", "inception4d",
                   "inception4e", "inception5a", "inception5b")}

#: Device scratch one call may hold; a larger batch runs as sub-batches
#: (:func:`sub_batch`). At D = 256 a window needs 4 MiB (stage 1+2),
#: 9.7 MB (s23), 4.7 MB (s3) or 2.8 MB (s45) in f32 and half that in bf16,
#: so a 512-window f32 batch runs whole and the CLI's 4096-window bf16 batch
#: in one part (stage 1+2, s45), two (s3) or three (s23).
SCRATCH_BUDGET_BYTES = 8 << 30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = [_P, _P, _P, _P, _I, _I, _P]
# src, pitch, rows, cols, origins, out, w, s, n, d, stream
_STAGE12_SIG = [_P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _P]
# x, ldx, n, H, W, Cin, K, stride, pad, w, b, Cout, y0, ldy0, split, y1, ldy1, stream
_CONV_SIG = [_P, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _L, _I, _P, _L, _P]
_NAMES = ("fused_stage12", "trunk_s23", "trunk_s3", "trunk_s45")
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = CudaKernel("trunk.cu", {**{f"srcf_{n}_{s}": _STAGE12_SIG if n == "fused_stage12" else _SIG
                                    for n in _NAMES for s in _SUFFIX.values()},
                                 **{f"srcf_conv_{s}": _CONV_SIG for s in _SUFFIX.values()},
                                 "srcf_conv_bf16_tile": _CONV_SIG[:-1]})


def launches(name: str) -> int:
    """Launches of one of the entry points of :data:`_NAMES`, or of
    ``"conv"`` (all dtypes), since the last ``KERNEL.reset()``."""
    return sum(KERNEL.counts[f"srcf_{name}_{s}"] for s in _SUFFIX.values())


# ---- parameters ----------------------------------------------------------

def _cin(name):
    """Input channels of an inception block."""
    names = list(_INCEPTION)
    i = names.index(name)
    if i == 0:
        return 192
    ch1, _, ch3, _, ch5, proj = _INCEPTION[names[i - 1]]
    return ch1 + ch3 + ch5 + proj


def _kb(sd, name):
    """(kernel HWIO, bias (1, cout)) of one folded conv of the port's
    state_dict (conv weights OIHW)."""
    if f"{name}.conv.bias" not in sd:
        raise ValueError("trunk kernels need BN-folded weights "
                         "(models.googlenet.fold_state_dict / fold_inference)")
    w = torch.as_tensor(sd[f"{name}.conv.weight"]).permute(2, 3, 1, 0)
    return w.contiguous(), torch.as_tensor(sd[f"{name}.conv.bias"]).reshape(1, -1)


def _inception_params(sd, name):
    """One block's folded weights as a flat list of 12, splitting a
    ``fused0`` wide 1x1 back into the three per-branch 1x1s: k1, b1, k2r,
    b2r, k2 (3x3), b2, k3r, b3r, k3 (3x3), b3, kp, bp."""
    ch1, red3, _, red5, _, _ = _INCEPTION[name]
    if f"{name}.fused0.conv.weight" in sd:
        k, b = _kb(sd, f"{name}.fused0")
        k = k.reshape(k.shape[2], -1)
        k1, k2r, k3r = torch.split(k, (ch1, red3, red5), dim=1)
        b1, b2r, b3r = torch.split(b, (ch1, red3, red5), dim=1)
    else:
        (k1, b1), (k2r, b2r), (k3r, b3r) = (
            _kb(sd, f"{name}.{br}") for br in ("branch1", "branch2.0", "branch3.0"))
        k1, k2r, k3r = (a.reshape(a.shape[2], -1) for a in (k1, k2r, k3r))
    k2, b2 = _kb(sd, f"{name}.branch2.1")     # 3x3 red3 -> ch3
    k3, b3 = _kb(sd, f"{name}.branch3.1")     # 3x3 red5 -> ch5 (torch quirk)
    kp, bp = _kb(sd, f"{name}.branch4.1")     # 1x1 cin -> proj
    kp = kp.reshape(kp.shape[2], -1)
    return [a.contiguous() for a in (k1, b1, k2r, b2r, k2, b2, k3r, b3r,
                                     k3, b3, kp, bp)]


def trunk_segment_params(sd, segment: str):
    """Flat weight list for :func:`trunk_s23` (``"s23"``),
    :func:`trunk_s3` (``"s3"``) or :func:`trunk_s45` (``"s45"``) from the
    port's folded (optionally fused) ``state_dict``: s23 starts with conv2
    (64, 64), its bias, conv3 (3, 3, 64, 192) and its bias; then 12 per
    inception block (s3 is s23 without conv2 and conv3)."""
    if segment not in _BLOCKS:
        raise ValueError(f"unknown segment {segment!r}")
    out = []
    if segment == "s23":
        k2, b2 = _kb(sd, "conv2")
        k3, b3 = _kb(sd, "conv3")
        out = [k2.reshape(64, 64), b2, k3, b3]
    for name in _BLOCKS[segment]:
        out += _inception_params(sd, name)
    return out


def stage12_params(sd):
    """conv1 (49, 64), b1 (1, 64), conv2 (64, 64), b2 (1, 64), conv3
    (3, 3, 64, 192), b3 (1, 192) for :func:`fused_stage12` from the port's
    folded ``state_dict``."""
    (k1, b1), (k2, b2), (k3, b3) = (_kb(sd, n) for n in ("conv1", "conv2", "conv3"))
    return [k1.reshape(49, 64), b1, k2.reshape(64, 64), b2, k3, b3]


def _inception_shapes(name):
    ch1, red3, ch3, red5, ch5, proj = _INCEPTION[name]
    c = _cin(name)
    return [(c, ch1), (1, ch1), (c, red3), (1, red3), (3, 3, red3, ch3), (1, ch3),
            (c, red5), (1, red5), (3, 3, red5, ch5), (1, ch5), (c, proj), (1, proj)]


_SHAPES = {"fused_stage12": [(49, 64), (1, 64), (64, 64), (1, 64), (3, 3, 64, 192), (1, 192)],
           "trunk_s3": _inception_shapes("inception3a") + _inception_shapes("inception3b"),
           "trunk_s23": [(64, 64), (1, 64), (3, 3, 64, 192), (1, 192)]
           + _inception_shapes("inception3a") + _inception_shapes("inception3b"),
           "trunk_s45": sum((_inception_shapes(n) for n in _BLOCKS["s45"]), [])}


# ---- packing -----------------------------------------------------------------

class PackedParams:
    """One entry point's weights, shape-checked and laid out as both of
    its versions read them (from :func:`pack_params`): each inception's
    three 1x1s that read the block's input as one wide
    (cin, ch1 + red3 + red5) kernel and bias, so a block takes 8 tensors
    (wide k, wide b, k2, b2, k3, b3, kp, bp)."""

    def __init__(self, name, tensors):
        self.name, self.tensors = name, tensors


def pack_params(name, params, device=None, dtype=None) -> PackedParams:
    """Check ``params`` (from :func:`stage12_params` or
    :func:`trunk_segment_params`) against entry point ``name`` and pack
    them on ``device`` and ``dtype`` (default: where they are). Pass the
    result to the wrappers to pack once rather than on every call."""
    shapes = [tuple(p.shape) for p in params]
    if shapes != _SHAPES[name]:
        raise ValueError(f"{name}: weight shapes {shapes} != {_SHAPES[name]}")
    ps = [p.to(device=device or p.device, dtype=dtype or p.dtype).contiguous()
          for p in params]
    if name == "fused_stage12":
        return PackedParams(name, ps)
    head, blocks = (ps[:4], ps[4:]) if name == "trunk_s23" else ([], ps)
    for i in range(0, len(blocks), 12):
        k1, b1, k2r, b2r, k2, b2, k3r, b3r, k3, b3, kp, bp = blocks[i:i + 12]
        head += [torch.cat([k1, k2r, k3r], 1), torch.cat([b1, b2r, b3r], 1),
                 k2, b2, k3, b3, kp, bp]
    return PackedParams(name, head)


def _weights(name, params, x=None):
    """The packed tensors of ``params`` for entry point ``name``, packed
    here unless :func:`pack_params` did it; with ``x``, on its device and
    dtype."""
    if not isinstance(params, PackedParams):
        params = pack_params(name, params, *(() if x is None else (x.device, x.dtype)))
    if params.name != name:
        raise ValueError(f"{name}: weights packed for {params.name}")
    if x is not None and any((t.device, t.dtype) != (x.device, x.dtype)
                             for t in params.tensors):
        raise ValueError(f"{name}: weights packed for another device or dtype "
                         f"than the input's ({x.device}, {x.dtype})")
    return params.tensors


# ---- plain versions --------------------------------------------------------

def _conv_ref(x, k, b, stride=1, pad=0):
    """NCHW conv + bias + ReLU with a (cin, cout) or HWIO kernel."""
    if k.dim() == 2:
        k = k[None, None]
    w = k.to(device=x.device, dtype=x.dtype).permute(3, 2, 0, 1).contiguous()
    return F.relu(F.conv2d(x, w, b.reshape(-1).to(device=x.device, dtype=x.dtype),
                           stride, pad))


def _inception_ref(x, ws):
    """One inception block on NCHW ``x`` from its 8 packed tensors; the
    three 1x1s run as one wide conv, as the fused model and the kernel run
    them."""
    kw, bw, k2, b2, k3, b3, kp, bp = ws
    red3, red5 = k2.shape[2], k3.shape[2]
    o1, r2, r3 = torch.split(_conv_ref(x, kw, bw), (kw.shape[1] - red3 - red5, red3, red5),
                             dim=1)
    return torch.cat([o1, _conv_ref(r2, k2, b2, pad=1), _conv_ref(r3, k3, b3, pad=1),
                      _conv_ref(F.max_pool2d(x, 3, 1, 1), kp, bp)], dim=1)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _front_ref(wins, ws):
    """What fused_stage12's front kernel computes, NCHW: conv1, ceil-pool,
    conv2 of (B, D, D[, 1]) windows."""
    b, d = wins.shape[0], wins.shape[1]
    x = _conv_ref(wins.reshape(b, 1, d, d), ws[0].reshape(7, 7, 1, 64), ws[1], 2, 3)
    return _conv_ref(_ceil_maxpool(x, 3, 2), ws[2], ws[3])


def fused_stage12_ref(wins, params):
    """Plain version of :func:`fused_stage12`."""
    ws = _weights("fused_stage12", params)
    return _nhwc(_ceil_maxpool(_conv_ref(_front_ref(wins, ws), ws[4], ws[5], pad=1), 3, 2))


def _s3_ref(x, ws):
    """inception3a, 3b and the ceil-pool of NCHW ``x``; NHWC out."""
    return _nhwc(_ceil_maxpool(_inception_ref(_inception_ref(x, ws[:8]), ws[8:16]), 3, 2))


def trunk_s3_ref(x, params):
    """Plain version of :func:`trunk_s3`."""
    return _s3_ref(_nchw(x), _weights("trunk_s3", params))


def trunk_s23_ref(x, params):
    """Plain version of :func:`trunk_s23`."""
    ws = _weights("trunk_s23", params)
    k2, b2, k3, b3 = ws[:4]
    x = _conv_ref(_ceil_maxpool(_nchw(x), 3, 2), k2, b2)
    return _s3_ref(_ceil_maxpool(_conv_ref(x, k3, b3, pad=1), 3, 2), ws[4:])


def trunk_s45_ref(x, params):
    """Plain version of :func:`trunk_s45`."""
    ws = _weights("trunk_s45", params)
    x = _nchw(x)
    for i in range(5):
        x = _inception_ref(x, ws[8 * i:8 * (i + 1)])
    x = _ceil_maxpool(x, 2, 2)
    x = _inception_ref(_inception_ref(x, ws[40:48]), ws[48:56])
    return x.float().mean(dim=(2, 3)).to(x.dtype)


# ---- launch plans ----------------------------------------------------------

def scratch_plan(name, side):
    """NHWC shapes of one window's device scratch for entry point ``name``
    at input side ``side`` (D, h or g), in the order ``csrc/trunk.cu``
    takes them. ``fused_stage12`` keeps conv1's and pool1's maps in shared
    memory: its scratch is conv2's and conv3's outputs. ``trunk_s23``'s
    second map (conv2's output, dead after conv3) later holds branch 4's
    pooled input of 3a and 3b; ``trunk_s3``'s second map holds it; the last
    map of ``trunk_s45`` holds that of each of its blocks."""
    if name == "fused_stage12":
        d4 = side // 4
        return [(d4, d4, 64), (d4, d4, 192)]
    if name == "trunk_s3":
        return [(side, side, 160), (side, side, 256), (side, side, 256), (side, side, 480)]
    if name == "trunk_s23":
        h2, h4 = side // 2, side // 4
        return [(h2, h2, 64), (h2, h2, 64), (h2, h2, 192), (h4, h4, 192),
                (h4, h4, 160), (h4, h4, 256), (h4, h4, 480)]
    if name == "trunk_s45":
        return [(side, side, 240)] + [(side, side, 832)] * 3
    raise ValueError(f"unknown entry point {name!r}")


def sub_batch(name, n, side, dtype):
    """Windows per launch of ``name`` over a batch of ``n``: as many as
    keep its :func:`scratch_plan` within :data:`SCRATCH_BUDGET_BYTES`."""
    window_bytes = (sum(math.prod(s) for s in scratch_plan(name, side))
                    * torch.finfo(dtype).bits // 8)
    return max(1, min(n, SCRATCH_BUDGET_BYTES // window_bytes))


class ConvLaunch(NamedTuple):
    """One conv a segment launches: ``cin`` input channels read from
    channel ``x_off`` of a (side, side) map with pixel stride ``ldx``;
    ``cout`` outputs of a k x k / ``stride`` conv padded by ``pad``, the
    first ``split`` written from channel ``y_off`` of a map with pixel
    stride ``ldy0``, the rest from channel 0 of one with pixel stride
    ``ldy1``."""
    layer: str
    side: int
    cin: int
    ldx: int
    x_off: int
    cout: int
    k: int
    stride: int
    pad: int
    ldy0: int
    y_off: int
    split: int
    ldy1: int


def _plain_conv(layer, side, cin, cout, k, stride=1):
    return ConvLaunch(layer, side, cin, cin, 0, cout, k, stride, k // 2, cout, 0, cout, cout)


def _inception_plan(name, side):
    """An inception block's four convs: the wide 1x1 (branch 1 into the
    block output, the reductions into scratch), the two 3x3s reading the
    scratch, branch 4's 1x1 reading the pooled input."""
    ch1, red3, ch3, red5, ch5, proj = _INCEPTION[name]
    cin, cr, co = _cin(name), red3 + red5, ch1 + ch3 + ch5 + proj
    return [ConvLaunch(f"{name}.wide", side, cin, cin, 0, ch1 + cr, 1, 1, 0, co, 0, ch1, cr),
            ConvLaunch(f"{name}.branch2", side, red3, cr, 0, ch3, 3, 1, 1, co, ch1, ch3, co),
            ConvLaunch(f"{name}.branch3", side, red5, cr, red3, ch5, 3, 1, 1, co, ch1 + ch3,
                       ch5, co),
            ConvLaunch(f"{name}.branch4", side, cin, cin, 0, proj, 1, 1, 0, co,
                       ch1 + ch3 + ch5, proj, co)]


def conv_plan(name, side):
    """The convs entry point ``name`` launches through the conv dispatch
    at input side ``side`` (D, h or g), in the order and with the channel
    offsets and pixel strides of ``csrc/trunk.cu``. ``fused_stage12``'s
    conv1 and conv2 run inside its front kernel, so only conv3 is here."""
    if name == "fused_stage12":
        return [_plain_conv("conv3", side // 4, 64, 192, 3)]
    if name == "trunk_s3":
        return sum((_inception_plan(b, side) for b in _BLOCKS["s3"]), [])
    if name == "trunk_s23":
        return ([_plain_conv("conv2", side // 2, 64, 64, 1),
                 _plain_conv("conv3", side // 2, 64, 192, 3)] + conv_plan("trunk_s3", side // 4))
    if name == "trunk_s45":
        return sum((_inception_plan(b, side if i < 5 else side // 2)
                    for i, b in enumerate(_BLOCKS["s45"])), [])
    raise ValueError(f"unknown entry point {name!r}")


def tensor_core_ok(c: ConvLaunch, dtype=torch.bfloat16) -> bool:
    """The dispatch rule of ``csrc/trunk.cu`` (``launch``) for a conv on
    16-byte-aligned maps: the tensor-core kernel takes it in bf16 when
    every channel count, offset and pixel stride is a multiple of 8, so a
    16-byte vector of 8 channels stays inside one tap and aligned; the
    rest run on the FMA kernel."""
    return dtype == torch.bfloat16 and all(
        v % 8 == 0 for v in (c.cin, c.ldx, c.x_off, c.cout, c.split, c.ldy0, c.y_off, c.ldy1))


# ---- CUDA wrappers ---------------------------------------------------------

def _launch(name, out, weights, side, inputs):
    """Run entry point ``name`` over ``out.shape[0]`` windows in
    sub-batches of :func:`sub_batch` windows, each with the scratch of
    :func:`scratch_plan`; ``inputs(i, k)`` gives the C arguments that
    locate windows ``i .. i + k - 1``."""
    n = out.shape[0]
    sub = sub_batch(name, n, side, out.dtype)
    # scratch (and weights packed for this call alone) return to PyTorch's
    # caching allocator when this function ends; the allocator hands them
    # out again only to work queued later on the same stream, so the
    # kernels still read them safely
    scratch = [out.new_empty((sub,) + s) for s in scratch_plan(name, side)]
    wptr = (_P * len(weights))(*[t.data_ptr() for t in weights])
    sptr = (_P * len(scratch))(*[t.data_ptr() for t in scratch])
    fn = f"srcf_{name}_{_SUFFIX[out.dtype]}"
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        for i in range(0, n, sub):
            k = min(sub, n - i)
            KERNEL.launch(fn, *inputs(i, k), out[i:i + k].data_ptr(),
                          ctypes.cast(wptr, _P), ctypes.cast(sptr, _P), k, side, stream)
    return out


def _segment(name, x, out, params, side):
    """Run segment ``name`` (its input map ``x``) into ``out``."""
    return _launch(name, out, _weights(name, params, x), side,
                   lambda i, k: (x[i:i + k].data_ptr(),))


def _check(name, x, channels):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[3] != channels:
        raise ValueError(f"{name}: expected (B, h, h, {channels}), got {tuple(x.shape)}")
    return x.contiguous()


def _pixel_stride(t):
    """Pixel stride of an NHWC map that may be a channel slice of a wider,
    contiguous one."""
    n, h, w, c = t.shape
    ld = t.stride(2)
    if t.stride(3) != 1 or ld < c or t.stride(1) != w * ld or t.stride(0) != h * w * ld:
        raise ValueError(f"conv: map {tuple(t.shape)} with strides {t.stride()} is not a "
                         "channel slice of a contiguous NHWC map")
    return ld


def _conv_kernel_side(x, k, y0, y1, stride, pad):
    """The kernel side of :func:`conv`'s arguments, whose shapes must fit
    together."""
    kk = 1 if k.dim() == 2 else k.shape[0]
    outs = [y0] + ([] if y1 is None else [y1])
    n, h, w = x.shape[:3]
    ho, wo = (h + 2 * pad - kk) // stride + 1, (w + 2 * pad - kk) // stride + 1
    if (x.shape[3] != k.shape[-2] or sum(y.shape[3] for y in outs) != k.shape[-1]
            or any(tuple(y.shape[:3]) != (n, ho, wo) for y in outs)):
        raise ValueError(f"conv: input {tuple(x.shape)}, kernel {tuple(k.shape)} and "
                         f"outputs {[tuple(y.shape) for y in outs]} do not fit")
    return kk


def _conv_args(x, k, b, y0, y1, stride, pad):
    """The C arguments of csrc/trunk.cu's single-conv entry (all but the
    stream) for CUDA tensors, checked."""
    kk = _conv_kernel_side(x, k, y0, y1, stride, pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv: unsupported device {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"conv: dtype {x.dtype} not supported")
    outs = [y0] + ([] if y1 is None else [y1])
    if any((t.device, t.dtype) != (x.device, x.dtype) for t in [k, b] + outs):
        raise ValueError("conv: kernel, bias and outputs must share the input's device "
                         "and dtype")
    if not (k.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv: kernel and bias must be contiguous")
    y1 = y0 if y1 is None else y1
    n, h, w, cin = x.shape
    return (x.data_ptr(), _pixel_stride(x), n, h, w, cin, kk, stride, pad, k.data_ptr(),
            b.data_ptr(), k.shape[-1], y0.data_ptr(), _pixel_stride(y0), y0.shape[3],
            y1.data_ptr(), _pixel_stride(y1))


def conv(x, k, b, y0, y1=None, stride=1, pad=0):
    """Conv + bias + ReLU of the NHWC map ``x`` (B, H, W, cin) with ``k``
    ((cin, cout) or HWIO) and ``b`` (1, cout): the first ``y0.shape[3]``
    output channels go to ``y0``, the rest to ``y1``. Each map may be a
    channel slice of a wider one (``X[..., c0:c1]``), as the segments read
    and write them (:func:`conv_plan`). Plain version on the CPU; on a card
    the single-conv entry of ``csrc/trunk.cu`` with the segments' dispatch
    (:func:`tensor_core_ok`)."""
    if x.device.type == "cpu":
        _conv_kernel_side(x, k, y0, y1, stride, pad)
        out = _nhwc(_conv_ref(_nchw(x), k, b, stride, pad))
        y0.copy_(out[..., :y0.shape[3]])
        if y1 is not None:
            y1.copy_(out[..., y0.shape[3]:])
        return y0, y1
    args = _conv_args(x, k, b, y0, y1, stride, pad)
    with torch.cuda.device(x.device):
        KERNEL.launch(f"srcf_conv_{_SUFFIX[x.dtype]}", *args,
                      torch.cuda.current_stream(x.device).cuda_stream)
    return y0, y1


def conv_tile(x, k, b, y0, y1=None, stride=1, pad=0):
    """The block tile width the card's dispatch picks for :func:`conv` of
    these bf16 CUDA tensors: 64 or 128 on the tensor-core kernel, 0 on
    the FMA kernel. Launches nothing."""
    if x.dtype != torch.bfloat16:
        raise TypeError("conv_tile: the tensor-core dispatch is for bf16")
    return KERNEL.load().srcf_conv_bf16_tile(*_conv_args(x, k, b, y0, y1, stride, pad))


def _windows(plane, origins, dim):
    """(B, dim, dim) windows of the 2-D ``plane`` at ``origins`` (B, 2)
    (row, col); pixels outside the plane read 0, as the kernel reads them."""
    r = torch.arange(dim, device=plane.device)
    rows, cols = origins[:, :1] + r, origins[:, 1:] + r
    inside = (((rows >= 0) & (rows < plane.shape[0]))[:, :, None]
              & ((cols >= 0) & (cols < plane.shape[1]))[:, None, :])
    wins = plane[rows.clamp(0, plane.shape[0] - 1)[:, :, None],
                 cols.clamp(0, plane.shape[1] - 1)[:, None, :]]
    return torch.where(inside, wins, plane.new_zeros(()))


def fused_stage12_gather(plane, origins, dim, params):
    """:func:`fused_stage12` of the windows of side ``dim`` whose top-left
    pixels are ``origins`` (B, 2) int64 (row, col) of the 2-D ``plane``
    (the padded scene, ``detect.cnn_pipeline.reference_pad``), on its
    device; pixels outside the plane read 0. The kernel reads each
    window's halo from the plane, so the (B, dim, dim) windows are never
    written. Plain version on the CPU (windows gathered), CUDA kernel on
    a card."""
    if plane.dim() != 2 or plane.stride(1) != 1:
        raise ValueError(f"fused_stage12: expected a 2-D plane with unit column stride, got "
                         f"shape {tuple(plane.shape)} strides {plane.stride()}")
    if origins.dtype != torch.int64 or origins.dim() != 2 or origins.shape[1] != 2:
        raise TypeError(f"fused_stage12: origins must be (B, 2) int64, got "
                        f"{origins.dtype} {tuple(origins.shape)}")
    if origins.device != plane.device:
        raise ValueError(f"fused_stage12: origins on {origins.device}, windows on "
                         f"{plane.device}")
    if dim % 8:
        raise ValueError(f"fused_stage12: D % 8 == 0 required, got D = {dim}")
    if plane.device.type == "cpu":
        return fused_stage12_ref(_windows(plane, origins, dim), params)
    if plane.device.type != "cuda":
        raise ValueError(f"fused_stage12: unsupported device {plane.device}")
    if plane.dtype not in _SUFFIX:
        raise TypeError(f"fused_stage12: dtype {plane.dtype} not supported")
    origins = origins.contiguous()
    out = plane.new_empty((origins.shape[0], dim // 8, dim // 8, 192))
    rows, cols = plane.shape
    return _launch("fused_stage12", out, _weights("fused_stage12", params, plane), dim,
                   lambda i, k: (plane.data_ptr(), plane.stride(0), rows, cols,
                                 origins[i:i + k].data_ptr()))


def fused_stage12(wins, params):
    """(B, D, D, 1) windows -> (B, D/8, D/8, 192); ``params`` from
    :func:`stage12_params`. Plain version on the CPU, CUDA kernel on a card."""
    if wins.dim() != 4 or wins.shape[1] != wins.shape[2] or wins.shape[3] != 1:
        raise ValueError(f"fused_stage12: expected (B, D, D, 1), got {tuple(wins.shape)}")
    b, d = wins.shape[:2]
    origins = torch.stack([torch.arange(b, device=wins.device) * d,
                           torch.zeros(b, dtype=torch.int64, device=wins.device)], dim=1)
    return fused_stage12_gather(wins.contiguous().view(b * d, d), origins, d, params)


def trunk_s3(x, params):
    """(B, g, g, 192) stage-2 outputs after their pool -> (B, g/2, g/2, 480);
    ``params`` from :func:`trunk_segment_params` (``"s3"``). Plain version on
    the CPU, CUDA kernel on a card."""
    if x.device.type == "cpu":
        return trunk_s3_ref(x, params)
    x = _check("trunk_s3", x, 192)
    g = x.shape[1]
    if g % 2:
        raise ValueError(f"trunk_s3: even g required, got g = {g}")
    out = x.new_empty((x.shape[0], g // 2, g // 2, 480))
    return _segment("trunk_s3", x, out, params, g)


def trunk_s23(x, params):
    """(B, h, h, 64) conv1 outputs -> (B, h/8, h/8, 480); ``params`` from
    :func:`trunk_segment_params` (``"s23"``). Plain version on the CPU,
    CUDA kernel on a card."""
    if x.device.type == "cpu":
        return trunk_s23_ref(x, params)
    x = _check("trunk_s23", x, 64)
    h = x.shape[1]
    if h % 16:
        raise ValueError(f"trunk_s23: h % 16 == 0 required, got h = {h}")
    out = x.new_empty((x.shape[0], h // 8, h // 8, 480))
    return _segment("trunk_s23", x, out, params, h)


def trunk_s45(x, params):
    """(B, g, g, 480) -> (B, 1024) global-average-pooled trunk features
    (apply the fc head outside); ``params`` from
    :func:`trunk_segment_params` (``"s45"``). Plain version on the CPU,
    CUDA kernel on a card."""
    if x.device.type == "cpu":
        return trunk_s45_ref(x, params)
    x = _check("trunk_s45", x, 480)
    g = x.shape[1]
    if g % 2:
        raise ValueError(f"trunk_s45: even g required, got g = {g}")
    out = x.new_empty((x.shape[0], 1024))
    return _segment("trunk_s45", x, out, params, g)
